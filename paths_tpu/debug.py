"""Numeric sanitizers and debug modes.

The reference's only sanitizers are runtime panics: Colour::check() on
negative energy (colour.rs:56-60, called from trace.rs:39,80,82), negative
pdf / invalid microfacet-sample panics (material.rs:456-496), and mesh
metadata invariants (scene.rs:188).  Panicking inside a jitted wavefront
is not an option, so the equivalents are (SURVEY.md section 5):

  - ``debug_checks()``: context manager enabling jax_debug_nans +
    jax_enable_checks for a scope (runs eagerly re-compiled, slow: use on
    tiny repros);
  - ``validate_radiance``: the Colour::check() analogue over a whole wave --
    counts NaN / infinite / negative-energy samples and raises in strict
    mode; the CLI exposes it as ``--check``.

Determinism is itself a sanitizer here: all randomness is counter-based
(sampling/hashing.py), so any run is replayable bit-exactly regardless of
device layout -- the property safe Rust gave the reference for free.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import jax
import numpy as np


@contextlib.contextmanager
def debug_checks():
    """Enable jax nan-debugging and internal checks within the scope."""
    prev_nans = jax.config.jax_debug_nans
    prev_checks = jax.config.jax_enable_checks
    jax.config.update("jax_debug_nans", True)
    jax.config.update("jax_enable_checks", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nans)
        jax.config.update("jax_enable_checks", prev_checks)


@dataclass
class RadianceReport:
    n: int
    n_nan: int
    n_inf: int
    n_negative: int

    @property
    def ok(self) -> bool:
        return self.n_nan == 0 and self.n_inf == 0 and self.n_negative == 0

    def __str__(self):
        return (
            f"samples={self.n} nan={self.n_nan} inf={self.n_inf} "
            f"negative={self.n_negative}"
        )


def validate_radiance(colours, strict: bool = False) -> RadianceReport:
    """Colour::check() (colour.rs:56-60) over an (N, 3) radiance wave."""
    c = np.asarray(colours)
    nan = np.isnan(c).any(axis=-1)
    inf = np.isinf(c).any(axis=-1)
    neg = (c < 0.0).any(axis=-1) & ~nan
    rep = RadianceReport(
        n=len(c), n_nan=int(nan.sum()), n_inf=int(inf.sum()),
        n_negative=int(neg.sum()),
    )
    if strict and not rep.ok:
        raise FloatingPointError(f"invalid radiance: {rep}")
    return rep
