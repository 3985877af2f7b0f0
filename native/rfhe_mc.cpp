// Native Monte-Carlo engine (C++17 + OpenMP) for host-side fault campaigns.
//
// Role: the reference ships OpenMP twins of its Python simulators for
// high-trial-count runs (rfhe_framewk/src/four_step_ntt_protected.cpp,
// ntt_test/relia_ntt_sim.cpp).  This library plays that role for the GPU
// framework: exact op-granularity semantics (butterfly-level injection
// inside radix-2 NTT stages) that the vectorized JAX campaigns model at
// stage level, plus a fast 3-stage pipeline MC.  Exposed via C ABI for
// ctypes (rfhe_tpu/native.py).
//
// Fresh implementation; semantics cross-checked against the golden Python
// oracle through the test suite.

#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

using u64 = std::uint64_t;
using u128 = unsigned __int128;

namespace {

u64 pow_mod(u64 a, u64 e, u64 q) {
  u128 r = 1, b = a % q;
  while (e) {
    if (e & 1) r = (r * b) % q;
    b = (b * b) % q;
    e >>= 1;
  }
  return (u64)r;
}

struct Rng {
  std::mt19937_64 g;
  explicit Rng(u64 seed) : g(seed) {}
  u64 below(u64 n) { return std::uniform_int_distribution<u64>(0, n - 1)(g); }
  double uniform() { return std::uniform_real_distribution<double>(0, 1)(g); }
};

// per-thread derived seed (same convention as the reference's OpenMP twins)
u64 thread_seed(u64 seed, int tid) {
  return seed ^ (0x9E3779B97F4A7C15ULL * (u64)(tid + 1));
}

// ---------------------------------------------------------------------------
// radix-2 in-place NTT with op-indexed injection (butterfly-mult ops)
// ---------------------------------------------------------------------------

// Injection plan: up to 2 (op, kind) pairs per trial — the reference's
// multi-fault scenarios (relia_ntt_sim.cpp:401-405) inject at most two
// faults, all targeting distinct ops within one stage (:441-455).
// kind: 0 SBF, 1 DBF (distinct bits), 2 MLF (randomize in [0, q)).
struct Inject {
  long long ops[2] = {-1, -1};
  int kinds[2] = {0, 0};
  int n = 0;
};

u64 inject_val(u64 v, int kind, u64 q, Rng &rng) {
  int bits = 64 - __builtin_clzll(q);
  switch (kind) {
    case 0:
      return (v ^ (1ULL << rng.below(bits))) % q;
    case 1: {
      u64 b1 = rng.below(bits), b2 = rng.below(bits);
      while (b2 == b1) b2 = rng.below(bits);  // relia_ntt_sim.cpp:123-125
      return (v ^ (1ULL << b1) ^ (1ULL << b2)) % q;
    }
    default:
      return rng.below(q);
  }
}

u64 apply_plan(u64 v, long long op_idx, const Inject &inj, u64 q, Rng &rng) {
  for (int i = 0; i < inj.n; ++i)
    if (inj.ops[i] == op_idx) v = inject_val(v, inj.kinds[i], q, rng);
  return v;
}

// natural-order DIF-free iterative CT NTT (bit-reverse + butterflies),
// matching the oracle (rfhe_tpu/oracle/ntt.py) and relia_ntt_sim.py:98-136
long long ntt_inplace(std::vector<u64> &A, u64 root, u64 q,
                      const Inject &inj, long long op_idx, Rng &rng,
                      bool *injected_hit) {
  const size_t n = A.size();
  // bit-reverse permutation
  size_t j = 0;
  for (size_t i = 1; i < n; ++i) {
    size_t bit = n >> 1;
    while (j & bit) { j ^= bit; bit >>= 1; }
    j ^= bit;
    if (i < j) std::swap(A[i], A[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    u64 wlen = pow_mod(root, n / len, q);
    size_t half = len / 2;
    for (size_t i = 0; i < n; i += len) {
      u64 w = 1;
      for (size_t k = i; k < i + half; ++k) {
        u64 u = A[k];
        u64 v = (u64)(((u128)A[k + half] * w) % q);
        u64 v2 = apply_plan(v, op_idx, inj, q, rng);
        if (v2 != v && injected_hit) *injected_hit = true;
        v = v2;
        ++op_idx;
        A[k] = (u + v) % q;
        A[k + half] = (u + q - v) % q;
        w = (u64)(((u128)w * wlen) % q);
      }
    }
  }
  return op_idx;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Protected four-step NTT campaign at BUTTERFLY granularity with multi-fault
// scenarios (relia_ntt_sim.cpp:401-466 semantics: 4 detectors, op-indexed
// fault plans of 1-2 faults, optionally pinned to one stage's op range).
// kinds[0..nkinds-1]: 0 SBF, 1 DBF, 2 MLF.  target_stage: -1 = whole
// transform, 0/1/2 = stage op range (the reference's per-stage rows).
// out[0..6] = detected, batch1, intra, inter, batch2 catches, trials_run
// ---------------------------------------------------------------------------
void four_step_mc_multi(long long trials, long long N, u64 q, u64 g_root,
                        int fold_width, const int *kinds, int nkinds,
                        int target_stage, u64 seed, long long *out) {
  long long n1 = 1;
  while (n1 * n1 < N) n1 <<= 1;
  if (n1 * n1 != N) n1 >>= 1;
  long long n2 = N / n1;
  const u64 wN = pow_mod(g_root, (q - 1) / (u64)N, q);
  const u64 w_n1 = pow_mod(wN, (u64)n1, q);  // order n2
  const u64 w_n2 = pow_mod(wN, (u64)n2, q);  // order n1
  const u64 FOLD = (1ULL << fold_width) + 1;

  // dry run to count ops: per column n2/2*log2(n2), twiddle n1*n2, rows...
  long long s1 = 0, tw = n1 * n2, s2 = 0;
  for (long long m = 2; m <= n2; m <<= 1) s1 += n2 / 2;
  s1 *= n1;
  for (long long m = 2; m <= n1; m <<= 1) s2 += n1 / 2;
  s2 *= n2;
  const long long total_ops = s1 + tw + s2;
  // stage op ranges (relia_ntt_sim.cpp dry-run OpRanges)
  long long range_lo = 0, range_len = total_ops;
  if (target_stage == 0) { range_lo = 0; range_len = s1; }
  else if (target_stage == 1) { range_lo = s1; range_len = tw; }
  else if (target_stage == 2) { range_lo = s1 + tw; range_len = s2; }

  long long detected = 0, b1_c = 0, intra_c = 0, inter_c = 0, b2_c = 0;

#ifdef _OPENMP
#pragma omp parallel reduction(+ : detected, b1_c, intra_c, inter_c, b2_c)
#endif
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(thread_seed(seed, tid));
#ifdef _OPENMP
#pragma omp for
#endif
    for (long long t = 0; t < trials; ++t) {
      Inject inj;
      inj.n = nkinds > 2 ? 2 : nkinds;
      for (int f = 0; f < inj.n; ++f) {
        long long target;
        bool dup;
        do {  // distinct ops (relia_ntt_sim.cpp:444-448)
          target = range_lo + (long long)rng.below((u64)range_len);
          dup = false;
          for (int p = 0; p < f; ++p) dup |= (inj.ops[p] == target);
        } while (dup);
        inj.ops[f] = target;
        inj.kinds[f] = kinds[f];
      }
      // data: A[r][c] with a[c*n2 + r] layout (relia_ntt_sim.py:232-233)
      std::vector<std::vector<u64>> A((size_t)n2,
                                      std::vector<u64>((size_t)n1));
      for (auto &row : A)
        for (auto &v : row) v = rng.below(q);
      auto Ain = A;
      long long op = 0;
      // stage 1: column NTTs (root of order n2)
      for (long long c = 0; c < n1; ++c) {
        std::vector<u64> col((size_t)n2);
        for (long long r = 0; r < n2; ++r) col[(size_t)r] = A[(size_t)r][(size_t)c];
        op = ntt_inplace(col, w_n1, q, inj, op, rng, nullptr);
        for (long long r = 0; r < n2; ++r) A[(size_t)r][(size_t)c] = col[(size_t)r];
      }
      // batch-1 projection: <NTT(w), rowsums(in)> == <w, rowsums(out)>
      auto proj_ok = [&](const std::vector<std::vector<u64>> &in,
                         const std::vector<std::vector<u64>> &outm, u64 root,
                         bool cols) {
        size_t len = cols ? (size_t)n2 : (size_t)n1;
        std::vector<u64> sin(len, 0), sout(len, 0), w(len);
        if (cols) {
          for (size_t r = 0; r < (size_t)n2; ++r)
            for (size_t c = 0; c < (size_t)n1; ++c) {
              sin[r] = (sin[r] + in[r][c]) % q;
              sout[r] = (sout[r] + outm[r][c]) % q;
            }
        } else {
          for (size_t r = 0; r < (size_t)n2; ++r)
            for (size_t c = 0; c < (size_t)n1; ++c) {
              sin[c] = (sin[c] + in[r][c]) % q;
              sout[c] = (sout[c] + outm[r][c]) % q;
            }
        }
        for (auto &x : w) x = rng.below(q);
        auto what = w;
        Inject none;
        ntt_inplace(what, root, q, none, 0, rng, nullptr);
        u128 lhs = 0, rhs = 0;
        for (size_t i = 0; i < len; ++i) {
          lhs = (lhs + (u128)what[i] * sin[i]) % q;
          rhs = (rhs + (u128)w[i] * sout[i]) % q;
        }
        return lhs == rhs;
      };
      bool ok_b1 = proj_ok(Ain, A, w_n1, true);
      // twiddle stage with intra collision model (fold mod 2^W+1)
      bool intra = false;
      auto Bbefore = A;
      for (long long r = 0; r < n2; ++r) {
        u64 wr = pow_mod(wN, (u64)r, q);
        u64 val = 1;
        for (long long c = 0; c < n1; ++c) {
          u64 vt = (u64)(((u128)A[(size_t)r][(size_t)c] * val) % q);
          u64 v = apply_plan(vt, op, inj, q, rng);
          ++op;
          if (v != vt && (v % FOLD) != (vt % FOLD)) intra = true;
          A[(size_t)r][(size_t)c] = v;
          val = (u64)(((u128)val * wr) % q);
        }
      }
      // inter: <phi, rowsums(after)> == <phi, rowsums(T .* before)>
      bool inter_ok = true;
      {
        std::vector<u64> phi((size_t)n2);
        for (auto &x : phi) x = rng.below(q);
        u128 lhs = 0, rhs = 0;
        for (long long r = 0; r < n2; ++r) {
          u64 wr = pow_mod(wN, (u64)r, q);
          u64 val = 1;
          u64 sa = 0, sb = 0;
          for (long long c = 0; c < n1; ++c) {
            sa = (sa + A[(size_t)r][(size_t)c]) % q;
            sb = (sb + (u64)(((u128)Bbefore[(size_t)r][(size_t)c] * val) % q)) % q;
            val = (u64)(((u128)val * wr) % q);
          }
          lhs = (lhs + (u128)phi[(size_t)r] * sa) % q;
          rhs = (rhs + (u128)phi[(size_t)r] * sb) % q;
        }
        inter_ok = lhs == rhs;
      }
      // stage 2: row NTTs (root of order n1)
      auto Bin = A;
      for (long long r = 0; r < n2; ++r)
        op = ntt_inplace(A[(size_t)r], w_n2, q, inj, op, rng, nullptr);
      bool ok_b2 = proj_ok(Bin, A, w_n2, false);
      bool det = !ok_b1 || intra || !inter_ok || !ok_b2;
      if (det) {
        ++detected;  // per-detector attribution (relia_ntt_sim.cpp:458-462)
        if (!ok_b1) ++b1_c;
        if (intra) ++intra_c;
        if (!inter_ok) ++inter_c;
        if (!ok_b2) ++b2_c;
      }
    }
  }
  out[0] = detected;
  out[1] = b1_c;
  out[2] = intra_c;
  out[3] = inter_c;
  out[4] = b2_c;
  out[5] = trials;
}

// ---------------------------------------------------------------------------
// 3-stage pipeline MC (four_step_ntt_protected.py:219-297 semantics)
// ftype: 0 SCF-BF, 1 SCF-MBU, 2 MCF-PPE, 3 MCF-CTE, 4 MCF-CLE
// out[0..2] injected per stage, out[3..5] undetected per stage
// ---------------------------------------------------------------------------
void three_stage_mc(long long trials, long long S, u64 P, int W, int ftype,
                    u64 seed, long long *out) {
  const u64 M = (1ULL << W) - 1;
  const int pbits = 64 - __builtin_clzll(P);
  long long inj[3] = {0, 0, 0}, und[3] = {0, 0, 0};

#ifdef _OPENMP
#pragma omp parallel
#endif
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(thread_seed(seed, tid));
    long long linj[3] = {0, 0, 0}, lund[3] = {0, 0, 0};
#ifdef _OPENMP
#pragma omp for
#endif
    for (long long t = 0; t < trials; ++t) {
      const size_t n = (size_t)S;
      auto randmat = [&](std::vector<u64> &m, u64 hi) {
        for (auto &v : m) v = rng.below(hi);
      };
      std::vector<u64> A1(n * n), B1(n * n), C1(n * n), A2(n * n), B2(n * n),
          C3(n * n);
      randmat(A1, P);
      randmat(B1, P);
      auto matmul = [&](const std::vector<u64> &a, const std::vector<u64> &b,
                        std::vector<u64> &c) {
        for (size_t i = 0; i < n; ++i)
          for (size_t j = 0; j < n; ++j) {
            u128 acc = 0;
            for (size_t k = 0; k < n; ++k)
              acc += (u128)a[i * n + k] * b[k * n + j];
            c[i * n + j] = (u64)(acc % P);
          }
      };
      matmul(A1, B1, C1);
      std::vector<u64> X(n * n), T(n * n), Y(n * n);
      for (size_t i = 0; i < n * n; ++i) X[i] = C1[i] % M;
      randmat(T, M);
      for (size_t i = 0; i < n * n; ++i)
        Y[i] = (u64)(((u128)X[i] * T[i]) % M);
      for (size_t i = 0; i < n * n; ++i) B2[i] = Y[i] % P;
      randmat(A2, P);
      matmul(A2, B2, C3);

      int stage = (int)rng.below(3) + 1;
      auto corrupt_elem = [&](std::vector<u64> &m, u64 mod, int bw) {
        size_t idx = (size_t)rng.below(m.size());
        switch (ftype) {
          case 0:  // SCF-BF
          case 2:  // MCF-PPE
            m[idx] = (m[idx] ^ (1ULL << rng.below((u64)bw))) % mod;
            break;
          case 1: {  // SCF-MBU
            int K = bw >= 4 ? (int)(2 + rng.below(3)) : 2;
            int start = (int)rng.below((u64)std::max(1, bw - K + 1));
            m[idx] = (m[idx] ^ (((1ULL << K) - 1) << start)) % mod;
            break;
          }
          case 3: {  // MCF-CTE: high-bit biased
            int lo = std::max(1, bw / 2);
            m[idx] = (m[idx] ^ (1ULL << (lo + rng.below((u64)(bw - lo))))) % mod;
            break;
          }
          default:
            m[idx] = rng.below(mod);
        }
      };
      auto cle_matrix = [&](const std::vector<u64> &a,
                            const std::vector<u64> &b, std::vector<u64> &c) {
        size_t i = (size_t)rng.below(n), k0 = (size_t)rng.below(n);
        u64 mfac = 1 + rng.below(2);
        bool pos = rng.below(2) == 0;
        for (size_t jj = 0; jj < n; ++jj) {
          u64 d = (u64)(((u128)a[i * n + k0] * b[k0 * n + jj] % P) * mfac % P);
          c[i * n + jj] = pos ? (c[i * n + jj] + d) % P
                              : (c[i * n + jj] + P - d) % P;
        }
      };
      auto cle_vector = [&](std::vector<u64> &y) {
        size_t idx = (size_t)rng.below(n * n);
        u64 wrong = (u64)(((u128)X[idx] * T[idx]) % M);
        u64 ks[3] = {M - 1, 2, M - 2};
        y[idx] = (u64)(((u128)ks[rng.below(3)] * wrong) % M);
      };
      auto matcheck = [&](const std::vector<u64> &a, const std::vector<u64> &b,
                          const std::vector<u64> &c) {
        std::vector<u64> col(n, 0), row(n, 0);
        for (size_t i = 0; i < n; ++i)
          for (size_t k = 0; k < n; ++k) {
            col[k] = (col[k] + a[i * n + k]) % P;
            row[i] = (row[i] + b[i * n + k]) % P;
          }
        u128 lhs = 0, rhs = 0;
        for (size_t k = 0; k < n; ++k) lhs = (lhs + (u128)col[k] * row[k]) % P;
        for (auto v : c) rhs = (rhs + v) % P;
        return lhs == rhs;
      };
      auto fold = [&](u128 x) {
        u64 s = 0;
        while (x) {
          s += (u64)(x & M);
          x >>= W;
        }
        return s % M;
      };
      auto foldcheck = [&](const std::vector<u64> &y) {
        u64 sin = 0, sout = 0;
        for (size_t i = 0; i < n * n; ++i) {
          sin = (sin + (u64)(((u128)fold(X[i]) * fold(T[i])) % M)) % M;
          sout = (sout + fold(y[i])) % M;
        }
        return sin == sout;
      };
      bool det = false;
      if (stage == 1) {
        auto C1f = C1;
        if (ftype == 4) cle_matrix(A1, B1, C1f);
        else corrupt_elem(C1f, P, pbits);
        det = !matcheck(A1, B1, C1f);
      } else if (stage == 2) {
        auto Yf = Y;
        if (ftype == 4) cle_vector(Yf);
        else corrupt_elem(Yf, M, W);
        det = !foldcheck(Yf);
      } else {
        auto C3f = C3;
        if (ftype == 4) cle_matrix(A2, B2, C3f);
        else corrupt_elem(C3f, P, pbits);
        det = !matcheck(A2, B2, C3f);
      }
      ++linj[stage - 1];
      if (!det) ++lund[stage - 1];
    }
#ifdef _OPENMP
#pragma omp critical
#endif
    {
      for (int i = 0; i < 3; ++i) {
        inj[i] += linj[i];
        und[i] += lund[i];
      }
    }
  }
  for (int i = 0; i < 3; ++i) {
    out[i] = inj[i];
    out[3 + i] = und[i];
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Wide-prime reduction campaigns (pbits <= 60, products fit u128) — native
// twins of rfhe_tpu/faults/reduction_campaigns.py:montgomery_campaign and
// barrett_final_campaign, for archive-scale trial counts (the reference's
// 10k-trial intra/range/sum tables and montgomery fold sweeps:
// rfhe_framewk/src/{intra,range,sum}.txt, montgomery.py:148-190).
// ---------------------------------------------------------------------------

namespace {

int bitlen128(u128 v) {
  int n = 0;
  while (v) { ++n; v >>= 1; }
  return n;
}

bool is_probable_prime(u64 n, Rng &rng) {
  if (n < 4) return n > 1;
  if (!(n & 1)) return false;
  u64 d = n - 1;
  int r = 0;
  while (!(d & 1)) { d >>= 1; ++r; }
  for (int it = 0; it < 32; ++it) {
    u64 a = 2 + rng.below(n - 3);
    u64 x = pow_mod(a, d, n);
    if (x == 1 || x == n - 1) continue;
    bool comp = true;
    for (int j = 0; j < r - 1; ++j) {
      x = (u64)(((u128)x * x) % n);
      if (x == n - 1) { comp = false; break; }
    }
    if (comp) return false;
  }
  return true;
}

u64 prime_with_bitlen(int bits, Rng &rng) {
  for (;;) {
    u64 v = (1ULL << (bits - 1)) | rng.below(1ULL << (bits - 1)) | 1ULL;
    if (bits <= 1) v = 2;
    if (is_probable_prime(v, rng)) return v;
  }
}

// flip `count` distinct bits within bit_length(v) (reduction_campaigns.py:
// _flip_bits_in_elements; second flip only when bit_length >= 2)
u128 flip_bits(u128 v, int count, Rng &rng) {
  int bl = bitlen128(v);
  if (bl < 1) bl = 1;
  u64 b1 = rng.below((u64)bl);
  u128 out = v ^ ((u128)1 << b1);
  if (count >= 2 && bl >= 2) {
    u64 b2 = rng.below((u64)(bl - 1));
    if (b2 >= b1) ++b2;
    out ^= (u128)1 << b2;
  }
  return out;
}

}  // namespace

extern "C" {

// Montgomery REDC vector campaign (montgomery_campaign semantics).
// scheme flags: use_m (fold ECC on lowT*m' products), use_mp (fold ECC on
// m*p products), use_final ((T + m*p) % R == 0 check).
// out[0] = TP, out[1] = FN (harmful trials detected / missed).
void montgomery_mc(long long trials, int pbits, long long vec_len,
                   int fold_width, int use_m, int use_mp, int use_final,
                   int flip_count, u64 seed, long long *out) {
  Rng prng(seed);
  const u64 p = prime_with_bitlen(pbits, prng);
  const int kbits = pbits;
  const u128 Rmask = ((u128)1 << kbits) - 1;
  const u64 M = (1ULL << fold_width) - 1;
  // m' = -p^{-1} mod R via Newton iteration on 2-adic inverse
  u64 inv = 1;
  for (int i = 0; i < 6; ++i) inv *= 2 - p * inv;        // p^{-1} mod 2^64
  const u64 m_prime = (u64)(((u128)0 - inv) & Rmask);    // -p^{-1} mod R

  long long TP = 0, FN = 0;
#ifdef _OPENMP
#pragma omp parallel reduction(+ : TP, FN)
#endif
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(thread_seed(seed, tid));
    std::vector<u128> T((size_t)vec_len), pm((size_t)vec_len),
        pmp((size_t)vec_len);
#ifdef _OPENMP
#pragma omp for
#endif
    for (long long t = 0; t < trials; ++t) {
      u64 ecc_m = 0, ecc_mp = 0;
      for (long long i = 0; i < vec_len; ++i) {
        u64 a = rng.below(p), b = rng.below(p);
        T[(size_t)i] = (u128)a * b;
        u64 lowT = (u64)(T[(size_t)i] & Rmask);
        pm[(size_t)i] = (u128)lowT * m_prime;
        u64 m = (u64)(pm[(size_t)i] & Rmask);
        pmp[(size_t)i] = (u128)m * p;
        ecc_m = (ecc_m + (u64)(pm[(size_t)i] % M)) % M;
        ecc_mp = (ecc_mp + (u64)(pmp[(size_t)i] % M)) % M;
      }
      bool inject_m = rng.below(2) == 0;
      size_t idx = (size_t)rng.below((u64)vec_len);
      u128 pm_used = pm[idx], pmp_used = pmp[idx];
      if (inject_m) {
        pm_used = flip_bits(pm[idx], flip_count, rng);
        u64 m_used = (u64)(pm_used & Rmask);
        pmp_used = (u128)m_used * p;
      } else {
        pmp_used = flip_bits(pmp[idx], flip_count, rng);
      }
      u64 ecc_m_used =
          (u64)((ecc_m + M - (u64)(pm[idx] % M) + (u64)(pm_used % M)) % M);
      u64 ecc_mp_used =
          (u64)((ecc_mp + M - (u64)(pmp[idx] % M) + (u64)(pmp_used % M)) % M);
      bool det_m = use_m && inject_m && (ecc_m_used != ecc_m);
      bool det_mp = use_mp && (ecc_mp_used != ecc_mp);
      u128 total = T[idx] + pmp_used;
      bool det_final = use_final && ((total & Rmask) != 0);
      // harmful: reduced value differs from the clean path (only idx moves)
      u64 u_f = (u64)(total >> kbits);
      if (u_f >= p) u_f -= p;
      u128 tot_ok = T[idx] + pmp[idx];
      u64 u_ok = (u64)(tot_ok >> kbits);
      if (u_ok >= p) u_ok -= p;
      bool harmful = u_f != u_ok;
      bool detected = det_m || det_mp || det_final;
      if (harmful) {
        if (detected) ++TP;
        else ++FN;
      }
    }
  }
  out[0] = TP;
  out[1] = FN;
}

// barrett_final campaign (Intra 2^s+1 fold / Range windows / Sum mod Q
// under the 4 fault models of barrett_final.py:57-80).
// out[0]=undetected, out[1]=det_intra_only, out[2]=det_inter_only,
// out[3]=det_both.
void barrett_final_mc(long long trials, int pbits, int s_bits,
                      int fault_model, int use_intra, int use_range,
                      int use_sum, long long vec_len, u64 seed,
                      long long *out) {
  // Q = next prime >= 2^(pbits-1) (deterministic, matches next_prime_ge)
  Rng prng(seed);
  u64 Q = (1ULL << (pbits - 1));
  while (!is_probable_prime(Q, prng)) ++Q;
  const int K = bitlen128(Q - 1);
  const u128 mu = (((u128)1 << (2 * K))) / Q;
  const u64 Ms = (1ULL << s_bits) + 1;

  long long und = 0, intra_only = 0, inter_only = 0, both = 0;
#ifdef _OPENMP
#pragma omp parallel reduction(+ : und, intra_only, inter_only, both)
#endif
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    Rng rng(thread_seed(seed, tid));
    std::vector<u64> av((size_t)vec_len), bv((size_t)vec_len);
    std::vector<u128> c((size_t)vec_len);
#ifdef _OPENMP
#pragma omp for
#endif
    for (long long t = 0; t < trials; ++t) {
      u64 sum_ref = 0;
      for (long long i = 0; i < vec_len; ++i) {
        av[(size_t)i] = rng.below(Q);
        bv[(size_t)i] = rng.below(Q);
        c[(size_t)i] = (u128)av[(size_t)i] * bv[(size_t)i];
        sum_ref = (sum_ref + (u64)(c[(size_t)i] % Q)) % Q;
      }
      // inject: record faulty elements only (others stay clean)
      size_t idxs[2] = {0, 0};
      u128 cf[2] = {0, 0};
      int nf = 0;
      auto rnd_bits = [&](int nbits) {
        u128 v = 0;
        for (int got = 0; got < nbits; got += 32)
          v = (v << 32) | rng.below(1ULL << 32);
        return v & (((u128)1 << nbits) - 1);
      };
      if (fault_model == 1 || fault_model == 2) {
        int cnt = fault_model;
        idxs[0] = (size_t)rng.below((u64)vec_len);
        if (cnt == 2) {
          do { idxs[1] = (size_t)rng.below((u64)vec_len); }
          while (idxs[1] == idxs[0]);
        }
        for (int f = 0; f < cnt; ++f)
          cf[f] = rnd_bits(bitlen128(c[idxs[f]]) + 1);
        nf = cnt;
      } else if (fault_model == 3) {
        idxs[0] = (size_t)rng.below((u64)vec_len);
        cf[0] = flip_bits(c[idxs[0]], 2, rng);
        nf = 1;
      } else {
        idxs[0] = (size_t)rng.below((u64)vec_len);
        do { idxs[1] = (size_t)rng.below((u64)vec_len); }
        while (idxs[1] == idxs[0]);
        cf[0] = flip_bits(c[idxs[0]], 1, rng);
        cf[1] = flip_bits(c[idxs[1]], 1, rng);
        nf = 2;
      }
      bool intra_det = false, range_det = false;
      u64 sum_faulty = sum_ref;
      for (int f = 0; f < nf; ++f) {
        size_t i = idxs[f];
        u128 v = cf[f];
        if (use_intra) {
          u64 fa = av[i] % Ms, fb = bv[i] % Ms;
          u64 pf = (u64)(((u128)fa * fb) % Ms);
          if ((u64)(v % Ms) != pf) intra_det = true;
        }
        // Barrett reduce with range windows (t = v*mu needs < 2^128:
        // v < 2^(2*pbits+1), mu ~ 2^(K+1) -> pbits <= 60 is safe for 37)
        u128 tt = v * mu;
        u128 s_ = tt >> (2 * K);
        u128 sn = s_ * Q;
        bool pre_ok = v >= sn && (v - sn) < (u128)(2 * Q);
        u128 ci = v >= sn ? v - sn : 0;   // borrow -> window already failed
        u128 ci_red = ci >= Q ? ci - Q : ci;
        bool post_ok = ci_red < Q;
        if (use_range && !(pre_ok && post_ok)) range_det = true;
        // update Sum: replace this element's clean residue with faulty one
        sum_faulty = (u64)((sum_faulty + Q - (u64)(c[i] % Q)
                            + (u64)(ci_red % Q)) % Q);
      }
      bool sum_det = use_sum && (sum_faulty != sum_ref);
      bool inter_det = range_det || sum_det;
      bool detected = (use_intra && intra_det) || inter_det;
      if (!detected) ++und;
      else if (intra_det && inter_det) ++both;
      else if (intra_det) ++intra_only;
      else ++inter_only;
    }
  }
  out[0] = und;
  out[1] = intra_only;
  out[2] = inter_only;
  out[3] = both;
}

}  // extern "C"
