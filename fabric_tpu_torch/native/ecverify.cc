// Host-side batched ECDSA-P256 verification over libcrypto (dlopen'd,
// as collect.cc's SHA-256 is: no link-time OpenSSL dependency, no OpenSSL
// headers).  The port's copy of the JAX package's fabric_tpu/native/
// ecverify.cc.
//
// Purpose: the CSP's degraded mode (csp/cuda/provider.py: a failed
// dispatch or collect resealed on the host, the deadline host race, the
// breaker's host route) verifies whole flushes on the host, as fast as
// the machine allows: OpenSSL's nistz256 verify is a multiple of the
// pure-Python verifier's rate (csp/hostref.py), which answers only where
// no libcrypto loads.
//
// Semantics mirror hostref.verify exactly: DER-strict parse, r, s in
// [1, n-1], LOW-S enforced, then curve verification.

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

#include <dlfcn.h>

typedef uint8_t u8;
typedef int32_t i32;

namespace {

// -- libcrypto symbols.  Keys are built through the legacy EC_KEY API
// (simplest route from affine coordinates) but verification goes
// through EVP_PKEY_verify: on OpenSSL 3.x a bare ECDSA_do_verify pays
// the legacy->provider bridge PER CALL (~40x slower), while an
// EVP_PKEY wrapping the key exports to the provider once and every
// subsequent verify runs the optimized implementation.
struct Ossl {
  void* (*BN_bin2bn)(const u8*, int, void*) = nullptr;
  void (*BN_free)(void*) = nullptr;
  void* (*EC_KEY_new_by_curve_name)(int) = nullptr;
  void (*EC_KEY_free)(void*) = nullptr;
  int (*EC_KEY_set_public_key_affine_coordinates)(void*, void*, void*) =
      nullptr;
  void* (*EVP_PKEY_new)() = nullptr;
  void (*EVP_PKEY_free)(void*) = nullptr;
  int (*EVP_PKEY_set1_EC_KEY)(void*, void*) = nullptr;
  void* (*EVP_PKEY_CTX_new)(void*, void*) = nullptr;
  void (*EVP_PKEY_CTX_free)(void*) = nullptr;
  int (*EVP_PKEY_verify_init)(void*) = nullptr;
  int (*EVP_PKEY_verify)(void*, const u8*, size_t, const u8*, size_t) =
      nullptr;
  bool ok = false;
};

const Ossl& ossl() {
  static const Ossl o = [] {
    Ossl s;
    for (const char* name :
         {"libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"}) {
      void* h = dlopen(name, RTLD_NOW | RTLD_LOCAL);
      if (!h) continue;
      s.BN_bin2bn =
          reinterpret_cast<void* (*)(const u8*, int, void*)>(
              dlsym(h, "BN_bin2bn"));
      s.BN_free = reinterpret_cast<void (*)(void*)>(dlsym(h, "BN_free"));
      s.EC_KEY_new_by_curve_name = reinterpret_cast<void* (*)(int)>(
          dlsym(h, "EC_KEY_new_by_curve_name"));
      s.EC_KEY_free =
          reinterpret_cast<void (*)(void*)>(dlsym(h, "EC_KEY_free"));
      s.EC_KEY_set_public_key_affine_coordinates =
          reinterpret_cast<int (*)(void*, void*, void*)>(
              dlsym(h, "EC_KEY_set_public_key_affine_coordinates"));
      s.EVP_PKEY_new =
          reinterpret_cast<void* (*)()>(dlsym(h, "EVP_PKEY_new"));
      s.EVP_PKEY_free =
          reinterpret_cast<void (*)(void*)>(dlsym(h, "EVP_PKEY_free"));
      s.EVP_PKEY_set1_EC_KEY = reinterpret_cast<int (*)(void*, void*)>(
          dlsym(h, "EVP_PKEY_set1_EC_KEY"));
      s.EVP_PKEY_CTX_new = reinterpret_cast<void* (*)(void*, void*)>(
          dlsym(h, "EVP_PKEY_CTX_new"));
      s.EVP_PKEY_CTX_free =
          reinterpret_cast<void (*)(void*)>(dlsym(h, "EVP_PKEY_CTX_free"));
      s.EVP_PKEY_verify_init = reinterpret_cast<int (*)(void*)>(
          dlsym(h, "EVP_PKEY_verify_init"));
      s.EVP_PKEY_verify =
          reinterpret_cast<int (*)(void*, const u8*, size_t, const u8*,
                                   size_t)>(dlsym(h, "EVP_PKEY_verify"));
      if (s.BN_bin2bn && s.BN_free && s.EC_KEY_new_by_curve_name &&
          s.EC_KEY_free && s.EC_KEY_set_public_key_affine_coordinates &&
          s.EVP_PKEY_new && s.EVP_PKEY_free && s.EVP_PKEY_set1_EC_KEY &&
          s.EVP_PKEY_CTX_new && s.EVP_PKEY_CTX_free &&
          s.EVP_PKEY_verify_init && s.EVP_PKEY_verify) {
        s.ok = true;
        break;
      }
      dlclose(h);
    }
    return s;
  }();
  return o;
}

const int NID_P256 = 415;  // NID_X9_62_prime256v1

// P-256 group order n and n/2 (low-S bound), big-endian.
const u8 P256_N[32] = {
    0xff, 0xff, 0xff, 0xff, 0x00, 0x00, 0x00, 0x00,
    0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xbc, 0xe6, 0xfa, 0xad, 0xa7, 0x17, 0x9e, 0x84,
    0xf3, 0xb9, 0xca, 0xc2, 0xfc, 0x63, 0x25, 0x51};
const u8 P256_HALF_N[32] = {
    0x7f, 0xff, 0xff, 0xff, 0x80, 0x00, 0x00, 0x00,
    0x7f, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff, 0xff,
    0xde, 0x73, 0x7d, 0x56, 0xd3, 0x8b, 0xcf, 0x42,
    0x79, 0xdc, 0xe5, 0x61, 0x7e, 0x31, 0x92, 0xa8};

// big-endian compare of 32-byte values: returns <0, 0, >0
int cmp32(const u8* a, const u8* b) { return memcmp(a, b, 32); }

bool is_zero32(const u8* a) {
  for (int i = 0; i < 32; ++i)
    if (a[i]) return false;
  return true;
}

// Strict-DER ECDSA signature parse into 32-byte big-endian r, s
// (mirrors csp/api.py unmarshal_ecdsa_signature: exact lengths, no
// negative integers, minimal encoding).
bool parse_der(const u8* sig, int n, u8* r32, u8* s32) {
  auto read_int = [&](int& pos, u8* out) -> bool {
    if (pos + 2 > n || sig[pos] != 0x02) return false;
    int len = sig[pos + 1];
    pos += 2;
    if (len <= 0 || len > 33 || pos + len > n) return false;
    const u8* p = sig + pos;
    if (p[0] & 0x80) return false;                       // negative
    if (len > 1 && p[0] == 0x00 && !(p[1] & 0x80)) return false;  // non-minimal
    int skip = (len == 33) ? 1 : 0;
    if (skip && p[0] != 0x00) return false;              // 33 bytes must pad
    int eff = len - skip;
    if (eff > 32) return false;
    memset(out, 0, 32);
    memcpy(out + (32 - eff), p + skip, eff);
    pos += len;
    return true;
  };
  if (n < 8 || sig[0] != 0x30) return false;
  int body = sig[1];
  if (body != n - 2) return false;  // no long-form, exact length
  int pos = 2;
  if (!read_int(pos, r32)) return false;
  if (!read_int(pos, s32)) return false;
  return pos == n;
}

// The EVP_PKEY of a key (an on-curve check and one provider export), or
// nullptr for a key that is not on P-256.
void* build_pkey(const Ossl& o, const u8* q) {
  void* pkey = nullptr;
  void* eckey = o.EC_KEY_new_by_curve_name(NID_P256);
  if (!eckey) return nullptr;
  void* bx = o.BN_bin2bn(q, 32, nullptr);
  void* by = o.BN_bin2bn(q + 32, 32, nullptr);
  int okk = (bx && by)
                ? o.EC_KEY_set_public_key_affine_coordinates(eckey, bx, by)
                : 0;
  if (bx) o.BN_free(bx);
  if (by) o.BN_free(by);
  if (okk) {
    pkey = o.EVP_PKEY_new();
    if (pkey && o.EVP_PKEY_set1_EC_KEY(pkey, eckey) != 1) {
      o.EVP_PKEY_free(pkey);
      pkey = nullptr;
    }
  }
  o.EC_KEY_free(eckey);  // pkey holds its own reference
  return pkey;
}

// Keys across calls: the orderer's signature filter and a deliver
// client verify one lane a call, under a handful of keys, and wrapping a
// key costs more than verifying with it.  An EVP_PKEY is shared between
// threads for reading; a key past the bound is wrapped for its call.
const size_t KEY_CACHE_MAX = 4096;
std::mutex key_cache_mu;

std::map<std::string, void*>& key_cache() {  // 64-byte q -> pkey (null: bad)
  static auto* cache = new std::map<std::string, void*>();
  return *cache;
}

// The key's pkey; `owned` when the caller must free it.
void* cached_pkey(const Ossl& o, const std::string& kb, bool* owned) {
  *owned = false;
  {
    std::lock_guard<std::mutex> g(key_cache_mu);
    auto it = key_cache().find(kb);
    if (it != key_cache().end()) return it->second;
  }
  void* pkey = build_pkey(o, reinterpret_cast<const u8*>(kb.data()));
  if (pkey) {
    // the provider export, once, before the key is shared
    void* ctx = o.EVP_PKEY_CTX_new(pkey, nullptr);
    if (ctx) o.EVP_PKEY_CTX_free(ctx);
  }
  std::lock_guard<std::mutex> g(key_cache_mu);
  auto it = key_cache().find(kb);
  if (it != key_cache().end()) {  // another thread cached it meanwhile
    if (pkey) o.EVP_PKEY_free(pkey);
    return it->second;
  }
  if (key_cache().size() >= KEY_CACHE_MAX) {
    *owned = pkey != nullptr;
    return pkey;
  }
  key_cache().emplace(kb, pkey);
  return pkey;
}

}  // namespace

extern "C" {

// Verify n (key, digest, DER signature) triples on the host.
// qxy: n*64 bytes (32-byte big-endian x || y per lane);
// digests: n*32; sigs + sig_off/sig_len: concatenated DER signatures.
// out[i] = 1 valid / 0 invalid.  Returns 0 on success, -1 when
// libcrypto is unavailable (the caller takes hostref).
int fabric_ecdsa_verify_host(int n, const u8* qxy, const u8* digests,
                             const u8* sigs, const i32* sig_off,
                             const i32* sig_len, u8* out) {
  const Ossl& o = ossl();
  if (!o.ok) return -1;
  // Per-key verify context for this call: a block's lanes repeat a
  // handful of endorser/creator keys, each key's context is made once.
  struct KeyCtx {
    void* pkey = nullptr;
    void* ctx = nullptr;
    bool owned = false;
  };
  std::map<std::string, KeyCtx> keys;  // 64-byte q -> ctx (null = bad)
  for (int i = 0; i < n; ++i) {
    out[i] = 0;
    u8 r32[32], s32[32];
    if (!parse_der(sigs + sig_off[i], sig_len[i], r32, s32)) continue;
    // r, s in [1, n-1]; LOW-S enforced (hostref rejects high-S
    // before curve math, as the reference does)
    if (is_zero32(r32) || is_zero32(s32)) continue;
    if (cmp32(r32, P256_N) >= 0 || cmp32(s32, P256_N) >= 0) continue;
    if (cmp32(s32, P256_HALF_N) > 0) continue;

    std::string kb(reinterpret_cast<const char*>(qxy + 64 * size_t(i)), 64);
    auto it = keys.find(kb);
    if (it == keys.end()) {
      KeyCtx kc;
      kc.pkey = cached_pkey(o, kb, &kc.owned);
      if (kc.pkey) {
        kc.ctx = o.EVP_PKEY_CTX_new(kc.pkey, nullptr);
        if (kc.ctx && o.EVP_PKEY_verify_init(kc.ctx) != 1) {
          o.EVP_PKEY_CTX_free(kc.ctx);
          kc.ctx = nullptr;
        }
      }
      it = keys.emplace(std::move(kb), kc).first;
    }
    if (!it->second.ctx) continue;
    out[i] = o.EVP_PKEY_verify(it->second.ctx, sigs + sig_off[i],
                               size_t(sig_len[i]),
                               digests + 32 * size_t(i), 32) == 1
                 ? 1
                 : 0;
  }
  for (auto& kv : keys) {
    if (kv.second.ctx) o.EVP_PKEY_CTX_free(kv.second.ctx);
    if (kv.second.owned) o.EVP_PKEY_free(kv.second.pkey);
  }
  return 0;
}

}  // extern "C"
