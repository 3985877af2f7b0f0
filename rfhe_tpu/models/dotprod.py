"""Encrypted dot product via rotate-and-add folding — the reference's
end-to-end campaign workload (reliability_test/dotprod_test.cu:67-185:
encode → encrypt → multiply+relinearize+modswitch → rotate-fold tree →
decrypt/compare), rebuilt on this framework's scheme layer.

Works for both schemes; the fold is a log-depth rotation tree
(dotprod_test.cu:143-148, profile_framewk/src/dotprod_ckks.cpp:49-60).
"""
from __future__ import annotations

from typing import Union

import numpy as np

from ..fhe.bgv import BgvContext
from ..fhe.ckks import Ciphertext, CkksContext


def dot_product_ckks(ctx: CkksContext, ct_x: Ciphertext, ct_y: Ciphertext,
                     rescale: bool = True) -> Ciphertext:
    """All slots of the result hold <x, y> (over n/2 complex slots)."""
    prod = ctx.multiply_relin(ct_x, ct_y)
    if rescale:
        prod = ctx.rescale(prod)
    slots = ctx.params.n // 2
    step = 1
    while step < slots:
        prod = ctx.add(prod, ctx.rotate(prod, step))
        step <<= 1
    return prod


def dot_product_bgv(ctx: BgvContext, ct_x: Ciphertext, ct_y: Ciphertext,
                    mod_switch: bool = True) -> Ciphertext:
    """All slots hold Σ x_i·y_i mod t (sum over the full 2×(n/2) matrix)."""
    prod = ctx.multiply_relin(ct_x, ct_y)
    if mod_switch:
        prod = ctx.mod_switch_to_next(prod)
    half = ctx.params.n // 2
    step = 1
    while step < half:
        prod = ctx.add(prod, ctx.rotate_rows(prod, step))
        step <<= 1
    prod = ctx.add(prod, ctx.rotate_columns(prod))
    return prod
