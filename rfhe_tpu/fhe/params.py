"""Scheme parameter sets (L4).

Moduli chains are NTT-friendly primes q ≡ 1 (mod 2N), each < 2^31 so
residues live in uint32 — the same regime as the reference's SEAL
configs (10×31-bit + 11×30-bit at N=32768, profile_framewk/src/framewk.cpp:
1123-1131).  Key material is test-grade (σ=3.2 discrete gaussian, ternary
secrets); the framework's subject is reliability, not certified security.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from ..numth import find_ntt_primes


def make_prime_chain(n: int, bit_sizes: Sequence[int]) -> List[int]:
    """Distinct NTT primes (q ≡ 1 mod 2n) of the requested bit sizes, largest
    first within each size."""
    from collections import Counter
    need = Counter(bit_sizes)
    pool = {bits: find_ntt_primes(n, bits, count, negacyclic=True)
            for bits, count in need.items()}
    used = {bits: 0 for bits in need}
    out = []
    for bits in bit_sizes:
        out.append(pool[bits][used[bits]])
        used[bits] += 1
    if len(set(out)) != len(out):
        raise ValueError("duplicate primes in chain")
    return out


@dataclass(frozen=True)
class CkksParams:
    n: int
    moduli: Tuple[int, ...]          # q_0 .. q_L (q_0 = base, last = top level)
    scale: float
    sigma: float = 3.2
    alpha: int = 1                   # primes dropped per rescale

    @classmethod
    def make(cls, n: int = 4096, levels: int = 3,
             q0_bits: Optional[int] = None,
             scale_bits: int = 28) -> "CkksParams":
        """scale_bits <= 30: one prime per level (u32-native).

        scale_bits > 30: COMPOSITE scale — each level is a PAIR of
        ~scale_bits/2-bit primes and rescale drops both.  This is how the
        framework reaches the reference substrates' precision regime (SEAL
        uses scale 2^40..2^60 on 50-60-bit limbs,
        profile_framewk/src/dotprod_ckks.cpp:96-104) while every residue
        stays in uint32 for the int8-matmul and u32 datapaths: the wide word the
        reference gets from CUDA's 64-bit ALUs is replaced by one extra RNS
        limb per level.  The base q0 becomes a 31+30-bit pair for the same
        reason (the final message m·scale must survive under it)."""
        if q0_bits is None:
            # default 31-bit base, EXCEPT 30-bit at n=65536.  The only
            # stated reason was the memory budget of an accelerator kernel
            # that no longer exists; the value is inherited and kept so
            # default chains do not change (ROADMAP.md design debt 2).
            # Callers that need the extra bit pass q0_bits=31.
            q0_bits = 30 if n >= 65536 else 31
        if scale_bits <= 30:
            bits = [q0_bits] + [scale_bits] * levels
            alpha = 1
        else:
            hb = scale_bits // 2
            lb = scale_bits - hb
            if max(hb, lb) > 30:
                raise ValueError("composite scale supports up to 60 bits")
            bits = [q0_bits, 30] + [hb, lb] * levels
            alpha = 2
        return cls(n=n, moduli=tuple(make_prime_chain(n, bits)),
                   scale=float(2 ** scale_bits), alpha=alpha)

    @property
    def L(self) -> int:
        return len(self.moduli)


@dataclass(frozen=True)
class BfvParams:
    """BFV (scale-invariant) parameters: same chain shape as BGV — the
    message rides the high bits as Δ·m, Δ = ⌊Q/t⌋ (reference's SEAL BFV perf
    surface, profile_framewk/src/framewk.cpp:14-397)."""
    n: int
    moduli: Tuple[int, ...]
    t: int                           # plaintext modulus, t ≡ 1 mod 2n for batching
    sigma: float = 3.2

    @classmethod
    def make(cls, n: int = 4096, levels: int = 2, q_bits: int = 30,
             t_bits: int = 16) -> "BfvParams":
        moduli = make_prime_chain(n, [q_bits] * (levels + 1))
        t = find_ntt_primes(n, t_bits, 1, negacyclic=True)[0]
        return cls(n=n, moduli=tuple(moduli), t=t)

    @property
    def L(self) -> int:
        return len(self.moduli)


@dataclass(frozen=True)
class BgvParams:
    n: int
    moduli: Tuple[int, ...]
    t: int                           # plaintext modulus, t ≡ 1 mod 2n for batching
    sigma: float = 3.2

    @classmethod
    def make(cls, n: int = 4096, levels: int = 2, q_bits: int = 30,
             t_bits: int = 16) -> "BgvParams":
        moduli = make_prime_chain(n, [q_bits] * (levels + 1))
        t = find_ntt_primes(n, t_bits, 1, negacyclic=True)[0]
        return cls(n=n, moduli=tuple(moduli), t=t)

    @property
    def L(self) -> int:
        return len(self.moduli)
