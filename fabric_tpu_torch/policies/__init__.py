"""Policy engine of the port (copy of `fabric_tpu/policies`): signature
policies, the text DSL and the hierarchical manager with implicit meta
policies, all on the two-phase prepare/finish protocol that lets a whole
block's signatures go to one batched verify."""
