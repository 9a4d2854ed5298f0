"""The identities the bf16 builds of K1 and K3 rely on, on the CPU.

K1-bf16 (``csrc/rel_attention_bf16.cu``) computes each (row, key) score
once into a buffer, merges the row max over its key splits, turns the
scores into exp(s - max) in place, sums them per split and merges the sums
in a fixed order, then rounds P = e / sum to bf16 for P·V; a tile of masked
rows without dropout takes the closed form p = bf16(1/T).  K3-bf16 takes
D_i = Σ_j dp_ij p_ij from a row pass over the valid pairs (path (a): no
second forward output), writes dS from a key pass to a float32 scratch and
takes dq from that scratch in 64-key tiles, the keys at or past len read as
zeros; dS enters its products as three bf16 pieces.  ``k1_schedule`` and
``k3_schedule`` below model those schedules in plain PyTorch (bf16 rounding
by ``.to(torch.bfloat16)``, round to nearest even like the kernels'
``__float2bfloat16_rn``; products of bf16 values exact in float32); the
tests hold them, and each identity alone, against ``rel_attention_plain``
and ``rel_attention_bwd_plain`` on the same bf16 q, k, v.  Tiny sizes,
ragged lengths including 1 and T, T no multiple of the tiles, dropout off
and at 0.1.  No JAX.

Limits (those of ``chip_smoke.py``): a bf16 result within 2⁻⁷ of its
tensor's peak (one bf16 ulp: the model and the plain version may round a
value on either side of a tie), the row max within 1e-5 of max(1, |max|)
and the sum within 1e-5 relative, the float32 emb gradients within 1e-3
of their peaks.
"""

import numpy as np
import pytest
import torch

import test_torch_port_cores  # noqa: F401  (shares the cores)
from visinger_tpu_torch.ops.rel_attention import (MASK_VAL, dropout_keep,
                                                  rel_attention_bwd_plain,
                                                  rel_attention_plain)

T, C, HEADS, WINDOW = 37, 32, 2, 4      # T is no multiple of 16, 32 or 64
DK = C // HEADS
NB = 2 * WINDOW + 1
LENGTHS = [37, 20, 1, 33]                # T, straddling, 1, below T
SCALE = DK ** -0.5
TOL_BF16 = 2.0 ** -7
TOL_STATS = 1e-5
TOL_EMB = 1e-3
SEED = torch.tensor([99], dtype=torch.int32)


@pytest.fixture(autouse=True)
def _pinned_float32_state():
    """Float32 matmuls at full precision (another test in the worker may
    have lowered it) and no flush of denormals."""
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    torch.set_flush_denormal(False)
    yield
    torch.set_float32_matmul_precision(prec)


def bf(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, as float32."""
    return x.to(torch.bfloat16).float()


def _inputs(seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (len(lengths), T, C)).astype(np.float32)).bfloat16()
        for _ in range(4))
    ek, ev = (torch.from_numpy((rng.standard_normal((NB, DK))
                                * DK ** -0.5).astype(np.float32))
              for _ in range(2))
    return q, k, v, ek, ev, torch.tensor(lengths, dtype=torch.int32), g


def _keep(rate, b_n):
    return dropout_keep(SEED, b_n, HEADS, T, rate) if rate > 0 else None


def err_of_peak(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max())


def _band_rel(qh, table):
    """[rows, NB] qh · table[m]: the band bias (or band gradient) table."""
    return qh @ table.t()


def k1_schedule(q, k, v, ek, ev, lengths, *, rows, splits, rate=0.0):
    """K1-bf16's schedule: blocks of ``rows`` query rows in 16-row groups,
    ``splits`` key splits taking 16 keys of every 16·splits-key tile, one
    score per pair into a buffer.  Returns (out bf16, stats)."""
    b_n = q.shape[0]
    kt = 16 * splits
    keep = _keep(rate, b_n)
    out = torch.zeros(q.shape)
    stats = torch.zeros(b_n, HEADS, T, 2)
    for b in range(b_n):
        ln = min(int(lengths[b]), T)
        for h in range(HEADS):
            cols = slice(h * DK, (h + 1) * DK)
            qh, kh, vh = (a[b, :, cols].float() for a in (q, k, v))
            for q0 in range(0, T, rows):
                masked, valid = q0 >= ln, q0 + rows <= ln
                rr = torch.arange(q0, min(q0 + rows, T))
                if masked and keep is None:          # the closed form
                    pb = bf(torch.tensor(1.0 / T))
                    o = pb * vh.sum(0)
                    for m in range(NB):
                        j = rr + m - WINDOW
                        o = o + ((j >= 0) & (j < T)).float()[:, None] \
                            * pb * ev[m]
                    out[b, rr, cols] = bf(o)
                    stats[b, h, rr] = torch.tensor([MASK_VAL, float(T)])
                    continue
                kend = ln if valid else T
                n_tiles = -(-kend // kt)
                qpad = torch.zeros(rows, DK)
                qpad[:len(rr)] = qh[rr]
                rel = _band_rel(qpad, ek) * SCALE
                for g0 in range(0, rows, 16):
                    ri = torch.arange(q0 + g0, q0 + g0 + 16)
                    # (A) each split's scores of its keys, once
                    xs = []
                    for s in range(splits):
                        parts = []
                        for t0 in range(n_tiles):
                            j0 = t0 * kt + 16 * s
                            if j0 >= kend:
                                continue
                            jj = torch.arange(j0, j0 + 16)
                            kpad = torch.zeros(16, DK)
                            ok = jj < T
                            kpad[ok] = kh[jj[ok]]
                            x = qpad[g0:g0 + 16] @ kpad.t() * SCALE
                            off = jj[None, :] - ri[:, None]
                            band = off.abs() <= WINDOW
                            x = x + torch.where(band, torch.gather(
                                rel[g0:g0 + 16], 1,
                                (off + WINDOW).clamp(0, NB - 1)), 0.0)
                            pair = (ri[:, None] < ln) & (jj[None, :] < ln) \
                                & (t0 * kt < ln) & (not masked)
                            x = torch.where(pair, x, MASK_VAL)
                            x = torch.where(jj[None, :] < T, x, -torch.inf)
                            parts.append((jj, x))
                        xs.append(parts)
                    # (B) the max over the splits; per-split sums merged in
                    # split order
                    m = torch.full((16,), -torch.inf)
                    for parts in xs:
                        for _, x in parts:
                            m = torch.maximum(m, x.amax(1))
                    l_row = torch.zeros(16)
                    for parts in xs:
                        ls = torch.zeros(16)
                        for _, x in parts:
                            ls = ls + torch.exp(x - m[:, None]).sum(1)
                        l_row = l_row + ls
                    # (C) P = e / sum, dropped, rounded; the splits' O
                    # partials summed in split order; the band term
                    o = torch.zeros(16, DK)
                    band_p = torch.zeros(16, NB)
                    for parts in xs:
                        o_s = torch.zeros(16, DK)
                        for jj, x in parts:
                            p = torch.exp(x - m[:, None]) / l_row[:, None]
                            if keep is not None:
                                kk = torch.zeros(16, 16, dtype=torch.bool)
                                okr, okj = ri < T, jj < T
                                kk[okr[:, None] & okj[None, :]] = keep[
                                    b, h][ri[okr]][:, jj[okj]].flatten()
                                p = torch.where(kk, p / (1.0 - rate), 0.0)
                            p = bf(p)
                            vpad = torch.zeros(16, DK)
                            vpad[jj < T] = vh[jj[jj < T]]
                            o_s = o_s + p @ vpad
                            off = jj[None, :] - ri[:, None]
                            inb = (off.abs() <= WINDOW) & (jj[None, :] < T)
                            for r, c_ in inb.nonzero().tolist():
                                band_p[r, off[r, c_] + WINDOW] = p[r, c_]
                        o = o + o_s
                    o = o + band_p @ ev
                    keep_rows = ri < T
                    out[b, ri[keep_rows], cols] = bf(o[keep_rows])
                    stats[b, h, ri[keep_rows]] = torch.stack(
                        [m, l_row], 1)[keep_rows]
    return out.bfloat16(), stats


def split3(x: torch.Tensor):
    """x = hi + mid + lo, three bf16 pieces (as float32), as the kernels
    split dS for its bf16 products."""
    hi = bf(x)
    mid = bf(x - hi)
    return hi, mid, bf(x - hi - mid)


def k3_schedule(q, k, v, ek, ev, lengths, g, stats, *, rate=0.0, kb=32,
                qt=64, qk=64):
    """K3-bf16's schedule: the row pass's D_i over the valid pairs and band
    tables; the key pass's dS (to a [T, Tp] scratch) and dK, dV per block of
    ``kb`` keys over ``qt``-row query tiles, dS in three bf16 pieces; the dq
    pass from the scratch in ``qk``-key tiles, the keys at or past len read
    as zeros.  Returns (dq, dk, dv bf16, d emb_rel_k, d emb_rel_v, and the
    row pass's D [B, H, T])."""
    b_n = q.shape[0]
    keep = _keep(rate, b_n)
    ks = 1.0 / (1.0 - rate)
    dq, dk_, dv = (torch.zeros(q.shape) for _ in range(3))
    dek, dev = torch.zeros(NB, DK), torch.zeros(NB, DK)
    d_all = torch.zeros(b_n, HEADS, T)
    tp = -(-T // 4) * 4
    idx = torch.arange(T)
    off = idx[None, :] - idx[:, None]                     # j - i
    band = off.abs() <= WINDOW
    gat = (off + WINDOW).clamp(0, NB - 1)
    for b in range(b_n):
        ln = min(int(lengths[b]), T)
        valid = (idx[:, None] < ln) & (idx[None, :] < ln)
        for h in range(HEADS):
            cols = slice(h * DK, (h + 1) * DK)
            qh, kh, vh, gh = (a[b, :, cols].float() for a in (q, k, v, g))
            m, l_ = stats[b, h, :, 0], stats[b, h, :, 1]
            relk = _band_rel(qh, ek) * SCALE
            relg = _band_rel(gh, ev)
            x = qh @ kh.t() * SCALE + torch.where(
                band, torch.gather(relk, 1, gat), 0.0)
            x = torch.where(valid, x, MASK_VAL)
            p = torch.exp(x - m[:, None]) / l_[:, None]
            dp = gh @ vh.t() + torch.where(band, torch.gather(relg, 1, gat),
                                           0.0)
            pd = p
            if keep is not None:
                kp = keep[b, h]
                pd = torch.where(kp, p * ks, 0.0)
                dp = torch.where(kp, dp * ks, 0.0)
            pdb = bf(pd)
            # (R) D_i over the valid pairs only
            d_row = torch.where(valid, dp * p, 0.0).sum(1)
            d_all[b, h] = d_row
            ds = torch.where(valid, p * (dp - d_row[:, None]), 0.0)
            # (C) per key block over the query tiles: dS to the scratch,
            # dV += P^T G, dK += dS^T Q with dS's three pieces
            scratch = torch.full((T, tp), float("nan"))
            for j0 in range(0, T, kb):
                jj = slice(j0, min(j0 + kb, T))
                acc_k, acc_v = torch.zeros(kb, DK), torch.zeros(kb, DK)
                it0 = 0 if j0 < ln else ln // qt
                w = jj.stop - j0
                for i0 in range(it0 * qt, T, qt):
                    ii = slice(i0, min(i0 + qt, T))
                    if j0 < ln and i0 < ln:
                        scratch[ii, jj] = ds[ii, jj]
                        if jj.stop == T:
                            scratch[ii, T:tp] = 0.0
                        for piece in split3(ds[ii, jj].t()):
                            acc_k[:w] += piece @ qh[ii]
                    acc_v[:w] += pdb[ii, jj].t() @ gh[ii]
                dk_[b, jj, cols] = bf(acc_k[:w] * SCALE)
                dv[b, jj, cols] = bf(acc_v[:w])
            # (Q) dq from the scratch in qk-key tiles below len, zero past
            bands = torch.zeros(T, NB)
            bandp = torch.zeros(T, NB)
            for i in range(T):
                for mm in range(NB):
                    j = i + mm - WINDOW
                    if 0 <= j < T:
                        bands[i, mm] = ds[i, j]
                        bandp[i, mm] = pdb[i, j]
            for q0 in range(0, T, 32):
                ri = slice(q0, min(q0 + 32, T))
                if q0 >= ln:
                    continue                              # dq = 0
                acc = torch.zeros(ri.stop - q0, DK)
                for j0 in range(0, ln, qk):
                    tile = torch.zeros(ri.stop - q0, qk)
                    for c4 in range(0, qk, 4):
                        j = j0 + c4
                        if j < ln:                        # a whole chunk
                            w = min(4, tp - j)
                            tile[:, c4:c4 + w] = scratch[ri, j:j + w]
                    kpad = torch.zeros(qk, DK)
                    kj = torch.arange(j0, j0 + qk)
                    kpad[kj < T] = kh[kj[kj < T]]
                    for piece in split3(tile):
                        acc += piece @ kpad
                dq[b, ri, cols] = bf((acc + bands[ri] @ ek) * SCALE)
            dek += bands.t() @ qh * SCALE
            dev += bandp.t() @ gh
    return (dq.bfloat16(), dk_.bfloat16(), dv.bfloat16(), dek, dev), d_all


def _fwd_plain(q, k, v, ek, ev, lens, rate):
    return rel_attention_plain(q, k, v, ek, ev, lens, window=WINDOW,
                               scale=SCALE, seed=SEED, rate=rate,
                               with_stats=True)


def _stats_close(got, want):
    m_err = ((got[..., 0] - want[..., 0]).abs()
             / want[..., 0].abs().clamp(min=1.0)).max()
    l_err = ((got[..., 1] - want[..., 1]).abs() / want[..., 1]).max()
    assert float(m_err) <= TOL_STATS and float(l_err) <= TOL_STATS


@pytest.mark.parametrize("rows,splits", [(32, 2), (16, 1), (16, 3)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k1_row_tiling_and_fixed_order_merge_match_plain(rows, splits,
                                                         rate):
    """Row groups of 16, key splits of 16 keys a tile, one score a pair,
    the splits' max, sums and O partials merged in split order: out within
    one bf16 ulp of its peak, stats within 1e-5."""
    q, k, v, ek, ev, lens, _ = _inputs()
    out, stats = k1_schedule(q, k, v, ek, ev, lens, rows=rows,
                             splits=splits, rate=rate)
    ref, ref_stats = _fwd_plain(q, k, v, ek, ev, lens, rate)
    assert out.dtype == torch.bfloat16
    assert err_of_peak(out, ref) <= TOL_BF16
    _stats_close(stats, ref_stats)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_masked_rows_take_bf16_of_one_over_t(rate):
    """A row at or past len scores -1e4 at every key: p = 1/T, or
    keep/(T(1-rate)), rounded to bf16 before P·V and the band term, as the
    closed form (or P·V alone with dropout) computes."""
    q, k, v, ek, ev, lens, _ = _inputs(lengths=[20, 1])
    ref, stats = _fwd_plain(q, k, v, ek, ev, lens, rate)
    keep = _keep(rate, 2)
    for b, ln in enumerate([20, 1]):
        for h in range(HEADS):
            cols = slice(h * DK, (h + 1) * DK)
            vh = v[b, :, cols].float()
            for i in range(ln, T):
                p = torch.full((T,), 1.0 / T)
                if keep is not None:
                    p = torch.where(keep[b, h, i], p / (1.0 - rate), 0.0)
                p = bf(p)
                band = torch.zeros(NB)
                for m in range(NB):
                    if 0 <= i + m - WINDOW < T:
                        band[m] = p[i + m - WINDOW]
                want = bf(p @ vh + band @ ev)
                assert float((ref[b, i, cols].float() - want).abs().max()) \
                    <= TOL_BF16 * float(want.abs().max())
            assert torch.equal(stats[b, h, ln:, 0],
                               torch.full((T - ln,), MASK_VAL))
            assert torch.equal(stats[b, h, ln:, 1],
                               torch.full((T - ln,), float(T)))


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_k3_schedule_matches_plain_backward(rate):
    """The row pass's D_i, the key pass's dS scratch, dK and dV with dS in
    three bf16 pieces, and the dq pass from the scratch: dq, dk, dv within
    one bf16 ulp of their peaks, the emb gradients within 1e-3."""
    q, k, v, ek, ev, lens, g = _inputs(seed=1)
    _, stats = _fwd_plain(q, k, v, ek, ev, lens, rate)
    got, _ = k3_schedule(q, k, v, ek, ev, lens, g, stats, rate=rate)
    ref = rel_attention_bwd_plain(q, k, v, ek, ev, lens, g, window=WINDOW,
                                  scale=SCALE, seed=SEED, rate=rate)
    for i, (a, r) in enumerate(zip(got, ref)):
        assert a.dtype == r.dtype
        assert err_of_peak(a, r) <= (TOL_BF16 if i < 3 else TOL_EMB), i


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_d_from_valid_pairs_is_the_softmax_backward_sum(rate):
    """Path (a): D_i summed by the row pass over the pairs with i, j < len
    (a key at or past len has p = 0 for a valid row) is the sum the
    softmax's backward subtracts, Σ_j dp_ij p_ij over every key, with dp
    the dropped dP and p the float32 softmax (not the rounded P)."""
    q, k, v, ek, ev, lens, g = _inputs(seed=2)
    _, stats = _fwd_plain(q, k, v, ek, ev, lens, rate)
    _, d = k3_schedule(q, k, v, ek, ev, lens, g, stats, rate=rate)
    # autograd of the softmax alone: for s -> softmax(s) with upstream dp,
    # ds = p (dp - D); D = p · dp over every key
    keep = _keep(rate, len(LENGTHS))
    for b, ln in enumerate(LENGTHS):
        for h in range(HEADS):
            cols = slice(h * DK, (h + 1) * DK)
            qh, kh, vh, gh = (a[b, :, cols].double() for a in (q, k, v, g))
            idx = torch.arange(T)
            off = idx[None, :] - idx[:, None]
            band = off.abs() <= WINDOW
            gat = (off + WINDOW).clamp(0, NB - 1)
            x = qh @ kh.t() * SCALE + torch.where(band, torch.gather(
                qh @ ek.double().t() * SCALE, 1, gat), 0.0)
            ok = (idx[:, None] < ln) & (idx[None, :] < ln)
            x = torch.where(ok, x, MASK_VAL)
            p = torch.softmax(x, 1)
            dp = gh @ vh.t() + torch.where(band, torch.gather(
                gh @ ev.double().t(), 1, gat), 0.0)
            if keep is not None:
                dp = torch.where(keep[b, h], dp / (1.0 - rate), 0.0)
            want = (p * dp).sum(1)[:ln].float()
            got = d[b, h, :ln]
            assert float((got - want).abs().max()) <= 1e-5 * max(
                1.0, float(want.abs().max()))


def test_three_piece_bf16_split_is_exact():
    """hi + mid + lo carries a float32 bit for bit, for values of either
    sign from 2^-100 to 2^100 (three 8-bit significands hold 24 bits; the
    pieces need exponents down to 2^-23 below the value's, above bf16's
    least subnormal 2^-133); the product with a bf16 operand is then the
    float32 value's, summed in float64."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(4096) * 2.0 ** rng.integers(-100, 100, 4096)
         ).astype(np.float32)
    x = torch.from_numpy(x)
    hi, mid, lo = split3(x)
    for piece in (hi, mid, lo):
        assert torch.equal(bf(piece), piece)     # each a bf16 value
    assert torch.equal((hi + mid) + lo, x)
    kb = bf(torch.from_numpy(rng.standard_normal((4096, 3)).astype(
        np.float32)))
    got = hi.double() @ kb.double() + mid.double() @ kb.double() \
        + lo.double() @ kb.double()
    assert torch.allclose(got, x.double() @ kb.double(), rtol=1e-12,
                          atol=0.0)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_dq_from_the_scratch_equals_the_row_pass_dq(rate):
    """dq taken from the key pass's dS scratch in 64-key tiles (keys at or
    past len read as zeros, rows past len skipped) equals dq from the dense
    dS of the row pass, dS K + band(dS) emb_rel_k, within one bf16 ulp of
    its peak, and is zero on every masked row."""
    q, k, v, ek, ev, lens, g = _inputs(seed=4)
    _, stats = _fwd_plain(q, k, v, ek, ev, lens, rate)
    for qk in (16, 64):
        (dq, *_), d = k3_schedule(q, k, v, ek, ev, lens, g, stats,
                                  rate=rate, qk=qk)
        keep = _keep(rate, len(LENGTHS))
        want = torch.zeros(q.shape)
        for b, ln in enumerate(LENGTHS):
            for h in range(HEADS):
                cols = slice(h * DK, (h + 1) * DK)
                qh, kh, vh, gh = (a[b, :, cols].float() for a in (q, k, v,
                                                                  g))
                idx = torch.arange(T)
                off = idx[None, :] - idx[:, None]
                band = off.abs() <= WINDOW
                gat = (off + WINDOW).clamp(0, NB - 1)
                ok = (idx[:, None] < ln) & (idx[None, :] < ln)
                x = qh @ kh.t() * SCALE + torch.where(band, torch.gather(
                    qh @ ek.t() * SCALE, 1, gat), 0.0)
                x = torch.where(ok, x, MASK_VAL)
                p = torch.exp(x - stats[b, h, :, :1]) / stats[b, h, :, 1:]
                dp = gh @ vh.t() + torch.where(band, torch.gather(
                    gh @ ev.t(), 1, gat), 0.0)
                if keep is not None:
                    dp = torch.where(keep[b, h], dp / (1.0 - rate), 0.0)
                ds = torch.where(ok, p * (dp - d[b, h][:, None]), 0.0)
                dq_row = ds @ kh
                for i in range(T):
                    for mm in range(NB):
                        j = i + mm - WINDOW
                        if 0 <= j < T:
                            dq_row[i] += ds[i, j] * ek[mm]
                want[b, :, cols] = dq_row * SCALE
            assert torch.equal(dq[b, ln:].float(),
                               torch.zeros(T - ln, C))
        assert err_of_peak(dq, want) <= TOL_BF16
