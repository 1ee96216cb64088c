"""Runtime seams of the port: the registered env knobs (`knob_registry`),
a patchable clock (`clockskew`) and deterministic fault injection
(`faultline`), copies of the JAX package's `fabric_tpu/devtools`
modules of the same names."""
