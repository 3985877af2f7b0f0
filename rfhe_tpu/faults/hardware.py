"""Hardware-style fault campaigns on real device buffers (L5) — the JAX
rebuild of reliability_test/: bit flips injected directly into device arrays
around real kernels, clean-vs-faulty differential measurement, and the
clean-vs-clean rerun that detects genuine silent hardware faults.

  ntt_flip_campaign      ntt_test.cu:22-199 — batched NTT, flip
                         `num_flips` bits in each of `num_target_symbols`
                         input symbols, rerun, report Hamming / bit-error /
                         symbol-error rates
  ntt_real_test          ntt_real_test.cu:21-171 — clean NTT twice, diff:
                         any mismatch is a genuine silent hardware fault
  ciphertext_flip        dotprod_test.cu:31-61 `_flip_bit_kernel` — xor a
                         single bit of one ciphertext residue on device
  dotprod_fault_campaign dotprod_test.cu:67-185 — encrypted dot product
                         with ciphertext injection, symbol/bit error stats
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.ntt import StackedNttPlan, negacyclic_ntt
from ..ops.u32 import popcount32


@dataclass
class ErrorStats:
    hamming_bits: int
    total_bits: int
    symbol_errors: int
    total_symbols: int

    @property
    def bit_error_rate(self) -> float:
        return self.hamming_bits / max(1, self.total_bits)

    @property
    def symbol_error_rate(self) -> float:
        return self.symbol_errors / max(1, self.total_symbols)


def compare_buffers(clean: jnp.ndarray, faulty: jnp.ndarray,
                    bits_per_symbol: int = 32) -> ErrorStats:
    """Hamming + symbol error statistics between two u32 device buffers
    (ntt_test.cu:153-198)."""
    x = jnp.bitwise_xor(clean, faulty)
    hamming = int(jnp.sum(popcount32(x)))
    symbols = int(jnp.sum((x != 0).astype(jnp.int32)))
    return ErrorStats(
        hamming_bits=hamming,
        total_bits=clean.size * bits_per_symbol,
        symbol_errors=symbols,
        total_symbols=clean.size,
    )


def flip_bits_host_style(x: jnp.ndarray, key, num_flips: int,
                         num_target_symbols: int,
                         bitwidth: int = 32) -> jnp.ndarray:
    """Flip `num_flips` random bits in each of `num_target_symbols` randomly
    chosen elements (matches the host-side injection of ntt_test.cu:104-135,
    but executed on device via scatter-xor)."""
    flat = x.reshape(-1)
    k1, k2 = jax.random.split(key)
    idx = jax.random.choice(k1, flat.shape[0], shape=(num_target_symbols,),
                            replace=False)
    bits = jax.random.randint(k2, (num_target_symbols, num_flips), 0,
                              bitwidth, dtype=jnp.uint32)
    masks = jnp.zeros((num_target_symbols,), dtype=jnp.uint32)
    for f in range(num_flips):
        masks = masks ^ (jnp.uint32(1) << bits[:, f])
    return flat.at[idx].set(flat[idx] ^ masks).reshape(x.shape)


def ntt_flip_campaign(plan: StackedNttPlan, batch: int, num_flips: int,
                      num_target_symbols: int, seed: int = 0
                      ) -> Tuple[ErrorStats, Dict]:
    """Injected-NTT campaign: clean batched forward NTT vs NTT of a
    bit-flipped input; error propagation statistics (ntt_test.cu)."""
    key = jax.random.PRNGKey(seed)
    k_data, k_flip = jax.random.split(key)
    L = plan.L
    n = plan.n
    qmax = int(np.asarray(plan.q_arr).min())
    x = jax.random.randint(k_data, (batch, L, n), 0, qmax, dtype=jnp.uint32)

    f = jax.jit(lambda v: negacyclic_ntt(v, plan))
    clean = f(x)
    x_f = flip_bits_host_style(x, k_flip, num_flips, num_target_symbols,
                               bitwidth=int(qmax).bit_length())
    faulty = f(x_f)
    stats = compare_buffers(clean, faulty)
    info = {
        "input_symbols_corrupted": int(jnp.sum((x != x_f).astype(jnp.int32))),
        "batch": batch, "L": L, "n": n,
    }
    return stats, info


def ntt_real_test(plan: StackedNttPlan, batch: int, seed: int = 0
                  ) -> ErrorStats:
    """Clean-vs-clean differential: run the same NTT twice on device and
    diff.  Nonzero Hamming = genuine silent hardware fault
    (ntt_real_test.cu; the reference triggers these with GPU overclocking,
    gpu_overclock/set_oc.sh — here we only monitor)."""
    key = jax.random.PRNGKey(seed)
    L, n = plan.L, plan.n
    qmax = int(np.asarray(plan.q_arr).min())
    x = jax.random.randint(key, (batch, L, n), 0, qmax, dtype=jnp.uint32)
    f = jax.jit(lambda v: negacyclic_ntt(v, plan))
    a = f(x).block_until_ready()
    b = f(x).block_until_ready()
    return compare_buffers(a, b)


def ciphertext_flip(ct_data: jnp.ndarray, global_bit_index: int,
                    word_bits: int = 32) -> jnp.ndarray:
    """Flip one absolute bit of a ciphertext residue buffer — the JAX
    equivalent of the one-thread CUDA `_flip_bit_kernel`
    (dotprod_test.cu:31-33)."""
    word = global_bit_index // word_bits
    bit = global_bit_index % word_bits
    flat = ct_data.reshape(-1)
    return flat.at[word].set(flat[word] ^ jnp.uint32(1 << bit)).reshape(
        ct_data.shape)


def dotprod_fault_campaign(bgv_ctx, bits_per_symbol: int, num_symbols: int,
                           seed: int = 0) -> Dict:
    """Encrypted BGV dot product with ciphertext injection
    (dotprod_test.cu:67-185): inject `bits_per_symbol` flips into each of
    `num_symbols` ciphertext words, then multiply/relinearize/fold and
    compare against the clean plaintext result."""
    from ..models.dotprod import dot_product_bgv
    rng = np.random.default_rng(seed)
    t = bgv_ctx.t
    shape = (2, bgv_ctx.params.n // 2)
    m1 = rng.integers(0, t, shape, dtype=np.uint32)
    m2 = rng.integers(0, t, shape, dtype=np.uint32)
    ct1 = bgv_ctx.encrypt(bgv_ctx.encode(m1))
    ct2 = bgv_ctx.encrypt(bgv_ctx.encode(m2))
    # inject into ct1.c0 buffer
    data = ct1.c[0].data
    total_bits = data.size * 32
    for _ in range(num_symbols):
        word = int(rng.integers(0, data.size))
        for _ in range(bits_per_symbol):
            data = ciphertext_flip(data, word * 32 + int(rng.integers(0, 30)))
    from ..fhe.rns import RnsPoly
    from ..fhe.ckks import Ciphertext
    ct1_f = Ciphertext([RnsPoly(data, True), ct1.c[1]], 1.0)

    # early differential: decrypt product before folding
    prod_clean = bgv_ctx.multiply_relin(ct1, ct2)
    prod_fault = bgv_ctx.multiply_relin(ct1_f, ct2)
    d_clean = bgv_ctx.decrypt_decode(prod_clean)
    d_fault = bgv_ctx.decrypt_decode(prod_fault)
    expect = (m1.astype(np.uint64) * m2) % t
    sym_err = int((d_fault != expect).sum())
    bit_err = int(sum(bin(int(a) ^ int(b)).count("1")
                      for a, b in zip(d_fault.reshape(-1), expect.reshape(-1))))
    # full dot product comparison
    full_clean = bgv_ctx.decrypt_decode(dot_product_bgv(bgv_ctx, ct1, ct2))
    full_fault = bgv_ctx.decrypt_decode(dot_product_bgv(bgv_ctx, ct1_f, ct2))
    expected_dot = int((m1.astype(object) * m2.astype(object)).sum()) % t
    return {
        "symbol_errors": sym_err,
        "total_symbols": int(np.prod(shape)),
        "bit_errors": bit_err,
        "clean_product_ok": bool((d_clean == expect).all()),
        "clean_dot_ok": int(full_clean[0, 0]) == expected_dot,
        "faulty_dot_value": int(full_fault[0, 0]),
        "expected_dot": expected_dot,
        "dot_hamming": bin(int(full_fault[0, 0]) ^ expected_dot).count("1"),
    }


def dotprod_stress(bgv_ctx, iterations: int = 20, seed: int = 0) -> Dict:
    """Key-reuse stress loop (naive_gemm_test.cu:26-103): run many encrypted
    dot products with pre-generated keys, verifying each against the
    plaintext result; any mismatch is a silent fault."""
    from ..models.dotprod import dot_product_bgv
    rng = np.random.default_rng(seed)
    t = bgv_ctx.t
    shape = (2, bgv_ctx.params.n // 2)
    failures = 0
    for it in range(iterations):
        m1 = rng.integers(0, t, shape, dtype=np.uint32)
        m2 = rng.integers(0, t, shape, dtype=np.uint32)
        ct = dot_product_bgv(bgv_ctx, bgv_ctx.encrypt(bgv_ctx.encode(m1)),
                             bgv_ctx.encrypt(bgv_ctx.encode(m2)))
        got = int(bgv_ctx.decrypt_decode(ct)[0, 0])
        expect = int((m1.astype(object) * m2.astype(object)).sum()) % t
        if got != expect:
            failures += 1
    return {"iterations": iterations, "failures": failures}
