"""Quasi-cyclic LDPC encoder and normalized min-sum decoder (JAX counterpart
``sim/ldpc.py``).

Reference: the link's FEC is Sionna's 5G LDPC
(``MimoSimulation/KerasFullSimulation.py:139-151``); the JAX package builds
an 802.11n-style quasi-cyclic code from a seeded prototype (block-lower-
triangular parity part, so encoding is back-substitution) and decodes it by
normalized min-sum. The prototype is numpy code, copied, so the code is
JAX's for the same seed.

The decoder keeps JAX's gather-only layout: messages in a dense padded check
layout ``[n_checks, dc_max]``, check updates as row-wise two-min and
sign-parity reductions, and each variable's sum gathered through a
``[n_vars, dv_max]`` index table and added in slot order. No
``index_add_`` / ``scatter_add_``: on the card those use atomics, whose order
varies from run to run, and posteriors near zero would flip. The adjacency
tensors are cached per (code, device).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class QCLDPC:
    """A lifted quasi-cyclic code: prototype ``proto`` with entries -1 (zero
    block) or shift s in [0, z); H = [A | T] with T block-lower-triangular,
    identity diagonal."""

    proto: tuple  # [mb][nb] int tuple-of-tuples
    z: int

    @property
    def mb(self) -> int:
        return len(self.proto)

    @property
    def nb(self) -> int:
        return len(self.proto[0])

    @property
    def kb(self) -> int:
        return self.nb - self.mb

    @property
    def n(self) -> int:
        return self.nb * self.z

    @property
    def k(self) -> int:
        return self.kb * self.z


def make_qc_ldpc(z: int = 27, kb: int = 12, mb: int = 12, seed: int = 0,
                 row_weight: int = 6) -> QCLDPC:
    """Construct a rate kb/(kb+mb) QC-LDPC prototype.

    Information part A: ``row_weight`` random circulant shifts per block row
    with simple 4-cycle avoidance (no two columns may repeat a shift
    difference within a column pair). Parity part T: dual-diagonal-style
    block-lower-triangular with identity (shift 0) blocks on the diagonal and
    one sub-diagonal identity per row, for exact back-substitution encoding.
    """
    rng = np.random.default_rng(seed)
    nb = kb + mb
    proto = -np.ones((mb, nb), dtype=np.int64)

    # Parity part: identity diagonal + sub-diagonal (bidiagonal T).
    for i in range(mb):
        proto[i, kb + i] = 0
        if i > 0:
            proto[i, kb + i - 1] = 0

    # Information part with 4-cycle avoidance between column pairs.
    # diff[(c1, c2)] = set of (s1 - s2) mod z seen for rows covering both.
    diffs: dict = {}
    for i in range(mb):
        cols = rng.choice(kb, size=min(row_weight, kb), replace=False)
        for c in cols:
            for _ in range(50):  # rejection sampling for girth > 4
                s = int(rng.integers(0, z))
                ok = True
                for c2 in range(kb):
                    if c2 == c or proto[i, c2] < 0:
                        continue
                    d = (s - proto[i, c2]) % z
                    key = (min(c, c2), max(c, c2))
                    dset = diffs.setdefault(key, set())
                    dd = d if c < c2 else (-d) % z
                    if dd in dset:
                        ok = False
                        break
                if ok:
                    proto[i, c] = s
                    for c2 in range(kb):
                        if c2 == c or proto[i, c2] < 0:
                            continue
                        d = (s - proto[i, c2]) % z
                        key = (min(c, c2), max(c, c2))
                        dd = d if c < c2 else (-d) % z
                        diffs.setdefault(key, set()).add(dd)
                    break
    return QCLDPC(proto=tuple(tuple(int(v) for v in row) for row in proto), z=z)


def ldpc_encode(code: QCLDPC, info_bits: torch.Tensor) -> torch.Tensor:
    """Systematic encoding: ``info_bits`` int [..., k] -> codeword [..., n].

    Solves A u + T p = 0 over GF(2) by block back-substitution (T is
    block-bidiagonal with identity diagonal): p_i = sum_j rot(u_j, s_ij)
    xor p_{i-1}.
    """
    z, kb, mb = code.z, code.kb, code.mb
    lead = info_bits.shape[:-1]
    u = info_bits.reshape(*lead, kb, z)
    parts = []
    prev = u.new_zeros((*lead, z))
    for i in range(mb):
        acc = u.new_zeros((*lead, z))
        for j in range(kb):
            s = code.proto[i][j]
            if s >= 0:
                # circulant block: H_block @ u_j == roll(u_j, -s)
                acc = acc ^ torch.roll(u[..., j, :], -s, dims=-1)
        prev = acc ^ prev  # T identity diag, sub-diag identity
        parts.append(prev)
    p = torch.stack(parts, dim=-2)
    return torch.cat([u.reshape(*lead, kb * z), p.reshape(*lead, mb * z)], dim=-1)


def _dense_adjacency(code: QCLDPC):
    """Padded adjacency tables for the gather-only decoder.

    Returns ``(check_vars [n_checks, dc_max] int, valid [n_checks, dc_max]
    bool, var_edges [n_vars, dv_max] int)`` where ``check_vars[c, j]`` is the
    variable on slot j of check c (pad 0, masked by ``valid``) and
    ``var_edges[v, i]`` indexes the flattened ``[n_checks*dc_max]`` message
    array (pad = n_checks*dc_max, pointing at an appended zero entry).
    """
    z = code.z
    block_cols = [[(j, s) for j, s in enumerate(row) if s >= 0] for row in code.proto]
    dc_max = max(len(c) for c in block_cols)
    n_checks = code.mb * z
    check_vars = np.zeros((n_checks, dc_max), np.int64)
    valid = np.zeros((n_checks, dc_max), bool)
    for i, cols in enumerate(block_cols):
        for slot, (j, s) in enumerate(cols):
            for r in range(z):
                check_vars[i * z + r, slot] = j * z + (r + s) % z
                valid[i * z + r, slot] = True
    lists: list = [[] for _ in range(code.n)]
    for c in range(n_checks):
        for slot in range(dc_max):
            if valid[c, slot]:
                lists[check_vars[c, slot]].append(c * dc_max + slot)
    dv_max = max(len(l) for l in lists)
    var_edges = np.full((code.n, dv_max), n_checks * dc_max, np.int64)
    for v, l in enumerate(lists):
        var_edges[v, : len(l)] = l
    return check_vars, valid, var_edges


@lru_cache(maxsize=None)
def _adjacency_tensors(code: QCLDPC, device: str):
    """:func:`_dense_adjacency` as tensors on ``device``, built once a (code,
    device): the code is frozen and hashable."""
    return tuple(torch.as_tensor(a, device=device) for a in _dense_adjacency(code))


def ldpc_decode(code: QCLDPC, llr: torch.Tensor, num_iters: int = 25,
                alpha: float = 0.75) -> torch.Tensor:
    """Normalized min-sum decoding (dense check layout, gather-only).

    ``llr``: float [..., n], positive favors bit 0 (as :func:`.qam.qam_llr`).
    Returns hard-decision info bits int32 [..., k].
    """
    cv, valid, var_edges = _adjacency_tensors(code, str(llr.device))
    lead = llr.shape[:-1]
    chan = llr.reshape(-1, code.n)
    inf = chan.new_tensor(np.inf)

    def check_update(v2c):
        """v2c [N, n_checks, dc_max] -> c2v (invalid slots produce 0)."""
        mag = torch.where(valid, torch.abs(v2c), inf)
        sgn = (valid & (v2c < 0)).long()
        s_tot = torch.sum(sgn, dim=-1) % 2  # parity
        m1 = torch.amin(mag, dim=-1)
        is_min = (mag <= m1[..., None]) & valid
        m2 = torch.amin(torch.where(is_min, inf, mag), dim=-1)
        # Outgoing magnitude excluding self: non-min slots see m1; a UNIQUE
        # min slot sees m2; tied-min slots see m1 (the other tie).
        cnt = torch.sum(is_min.long(), dim=-1)
        out_mag = torch.where(is_min & (cnt[..., None] == 1), m2[..., None], m1[..., None])
        out_sgn = (s_tot[..., None] + sgn) % 2
        c2v = alpha * torch.where(out_sgn == 1, -out_mag, out_mag)
        return torch.where(valid & torch.isfinite(c2v), c2v, 0.0)

    def var_sum(c2v):
        """Per-variable sum of incident c2v messages: a gather, summed in slot
        order (as XLA's reduction of JAX's ``jnp.sum(..., axis=1)``)."""
        flatc = torch.cat([c2v.reshape(c2v.shape[0], -1), c2v.new_zeros(c2v.shape[0], 1)],
                          dim=1)
        g = flatc[:, var_edges]  # [N, n_vars, dv_max]
        acc = g[..., 0]
        for i in range(1, g.shape[-1]):
            acc = acc + g[..., i]
        return acc

    v2c = chan[:, cv]
    for _ in range(num_iters):
        c2v = check_update(v2c)
        v2c = (chan + var_sum(c2v))[:, cv] - c2v
    posterior = chan + var_sum(check_update(v2c))
    hard = (posterior < 0).to(torch.int32)
    return hard.reshape(*lead, code.n)[..., : code.k]


def ldpc_syndrome(code: QCLDPC, codeword: torch.Tensor) -> torch.Tensor:
    """H @ c mod 2 (all-zero iff ``codeword`` is valid): a test and debug helper."""
    cv, valid, _ = _adjacency_tensors(code, str(codeword.device))
    flat = codeword.reshape(-1, code.n)
    syn = torch.sum(torch.where(valid, flat[:, cv], 0), dim=-1) % 2
    return syn.reshape(*codeword.shape[:-1], code.mb * code.z)
