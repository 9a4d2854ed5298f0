"""The identities K1's tensor-core schedule relies on, on the CPU.

K1 (``csrc/rel_attention.cu``) splits a block's query rows into 16-row
groups and its keys into 8-key groups spread over key splits, each with its
own online softmax; it skips keys at or past an item's length for rows below
it, gives tiles of masked rows a closed form (or P·V alone with dropout)
and key tiles wholly at or past the length P·V alone,
stashes the band scores as the key loop computes them, merges the splits in
a fixed order, and feeds S's accumulator to P·V as its A fragment by reading
each 8-key group in a permuted order.  ``k1_schedule`` below is a model of
that schedule in plain PyTorch, its products through the kernels' 3xTF32
emulation (``ops/tf32x3.py``); the tests hold it, and each identity alone,
against ``rel_attention_plain``.  Tiny sizes, ragged lengths including 1
and T, T not a multiple of the tiles, dropout off and at 0.1.

Tolerance: 1e-5 max abs on out; the row max within 1e-5 of max(1, |max|)
and the row sum within 1e-5 relative — float32 sums in another order, and
3xTF32 products at float32 accuracy.
"""

import numpy as np
import pytest
import torch

from visinger_tpu_torch.ops.rel_attention import (MASK_VAL, dropout_keep,
                                                  rel_attention_plain)
from visinger_tpu_torch.ops.tf32x3 import matmul_3xtf32

import test_torch_port_cores  # noqa: F401  (shares the cores)

ATOL = 1e-5
T, C, HEADS, WINDOW = 37, 32, 2, 4      # T is no multiple of 8, 16 or 32
DK = C // HEADS
LENGTHS = [37, 20, 1, 33]                # T, straddling, 1, below T
SCALE = DK ** -0.5
PERM = [0, 2, 4, 6, 1, 3, 5, 7]          # k-index -> key of an 8-key group


@pytest.fixture(autouse=True)
def _pinned_float32_state():
    """Pin the process-wide state the float32 sums here could depend on
    (another test in the same worker may change it): matmul precision
    "highest" (at "medium" the CPU matmuls run in bfloat16 and out misses by
    ~8e-3), no flush of denormals, float32 as the default dtype."""
    prec = torch.get_float32_matmul_precision()
    dtype = torch.get_default_dtype()
    torch.set_float32_matmul_precision("highest")
    torch.set_flush_denormal(False)
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_float32_matmul_precision(prec)
    torch.set_default_dtype(dtype)


def _inputs(seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (len(lengths), T, C)).astype(np.float32)) for _ in range(3))
    ek, ev = (torch.from_numpy((rng.standard_normal(
        (2 * WINDOW + 1, DK)) * DK ** -0.5).astype(np.float32))
        for _ in range(2))
    return q, k, v, ek, ev, torch.tensor(lengths, dtype=torch.int32)


def k1_schedule(q, k, v, ek, ev, lengths, *, rows, splits, seed=None,
                rate=0.0):
    """K1's schedule: blocks of ``rows`` query rows (16 or 32), row groups
    of 16, ``splits`` key splits taking 8 keys of every 8·splits-key tile.
    Returns (out [B, T, C], stats [B, H, T, 2])."""
    b_n, t, c = q.shape
    nb, w = 2 * WINDOW + 1, WINDOW
    kt = 8 * splits
    keep = (dropout_keep(seed, b_n, HEADS, t, rate) if rate > 0 else None)
    kscale = 1.0 / (1.0 - rate)
    out = torch.zeros_like(q)
    stats = torch.zeros(b_n, HEADS, t, 2)
    for b in range(b_n):
        ln = min(int(lengths[b]), t)
        for h in range(HEADS):
            cols = slice(h * DK, (h + 1) * DK)
            qh, kh, vh = q[b, :, cols], k[b, :, cols], v[b, :, cols]
            for q0 in range(0, t, rows):
                masked, valid = q0 >= ln, q0 + rows <= ln
                rr = torch.arange(q0, min(q0 + rows, t))
                if masked and keep is None:         # the closed form
                    o = vh.sum(0) * (1.0 / t)
                    for m in range(nb):
                        j = rr + m - w
                        o = o + ((j >= 0) & (j < t)).float()[:, None] \
                            * (1.0 / t) * ev[m]
                    out[b, rr, cols] = o
                    stats[b, h, rr] = torch.tensor([MASK_VAL, float(t)])
                    continue
                kend = ln if valid else t
                # band scores the loop does not compute
                band = torch.full((rows, nb), -float("inf"))
                for r in range(rows):
                    for m in range(nb):
                        i, j = q0 + r, q0 + r + m - w
                        if 0 <= j < t and (i >= ln or j >= ln):
                            band[r, m] = MASK_VAL
                qpad = torch.zeros(rows, DK)
                qpad[:len(rr)] = qh[rr]
                rel = qpad @ ek.t() * SCALE
                parts = []
                for g0 in range(0, rows, 16):
                    ri = torch.arange(q0 + g0, q0 + g0 + 16)
                    for s in range(splits):
                        m_run = torch.full((16,), -float("inf"))
                        l_run = torch.zeros(16)
                        o_run = torch.zeros(16, DK)
                        for t0 in range(0, kend, kt):
                            j0 = t0 + 8 * s
                            if j0 >= kend:
                                continue
                            jj = torch.arange(j0, j0 + 8)
                            kpad = torch.zeros(8, DK)
                            vpad = torch.zeros(8, DK)
                            ok = jj < t
                            kpad[ok], vpad[ok] = kh[jj[ok]], vh[jj[ok]]
                            if masked or t0 >= ln:    # no Q·Kᵀ here
                                x = torch.full((16, 8), MASK_VAL)
                            else:
                                x = matmul_3xtf32(qpad[g0:g0 + 16],
                                                  kpad.t()) * SCALE
                                off = jj[None, :] - ri[:, None]
                                inb = off.abs() <= w
                                x = x + torch.where(inb, torch.gather(
                                    rel[g0:g0 + 16], 1,
                                    (off + w).clamp(0, 2 * w)), 0.0)
                                bad = (ri[:, None] >= ln) | (jj[None, :] >= ln)
                                x = torch.where(bad, MASK_VAL, x)
                                for r, jl in inb.nonzero().tolist():
                                    if jj[jl] < t:
                                        band[g0 + r, jj[jl] - ri[r] + w] = \
                                            x[r, jl]
                            x = torch.where(ok[None, :], x, -float("inf"))
                            m_new = torch.maximum(m_run, x.amax(1))
                            alpha = torch.exp(m_run - m_new)
                            p = torch.exp(x - m_new[:, None])
                            l_run = l_run * alpha + p.sum(1)
                            m_run = m_new
                            pd = p
                            if keep is not None:
                                sub = keep[b, h][ri.clamp(max=t - 1)][
                                    :, jj.clamp(max=t - 1)]
                                pd = torch.where(sub, p * kscale, 0.0)
                            o_run = o_run * alpha[:, None] + matmul_3xtf32(
                                pd[:, PERM], vpad[PERM])
                        parts.append((g0, m_run, l_run, o_run))
                # the fixed-order merge, split 0 first
                for g0 in range(0, rows, 16):
                    mine = [p for p in parts if p[0] == g0]
                    m = mine[0][1]
                    for _, ms, _, _ in mine[1:]:
                        m = torch.maximum(m, ms)
                    ls = torch.zeros(16)
                    for _, ms, lp, _ in mine:
                        ls = ls + lp * torch.exp(ms - m)
                    o = torch.zeros(16, DK)
                    for _, ms, _, op in mine:
                        o = o + op * (torch.exp(ms - m) / ls)[:, None]
                    ri = torch.arange(q0 + g0, q0 + g0 + 16)
                    wb = torch.exp(band[g0:g0 + 16] - m[:, None]) / ls[:, None]
                    if keep is not None:
                        jb = ri[:, None] + torch.arange(nb)[None, :] - w
                        kb = keep[b, h][ri.clamp(max=t - 1)[:, None],
                                        jb.clamp(0, t - 1)]
                        wb = torch.where(kb, wb * kscale, 0.0)
                    o = o + wb @ ev
                    live = ri < t
                    out[b, ri[live], cols] = o[live]
                    stats[b, h, ri[live]] = torch.stack([m, ls], 1)[live]
    return out, stats


def _stats_close(got, want):
    """(max error of the row max relative to max(1, |max|), max relative
    error of the row sum, [b, h, i] of the worst row sum)."""
    m_err = ((got[..., 0] - want[..., 0]).abs()
             / want[..., 0].abs().clamp(min=1.0)).max()
    l_rel = (got[..., 1] - want[..., 1]).abs() / want[..., 1]
    worst = [int(x) for x in (l_rel == l_rel.max()).nonzero()[0]]
    return float(m_err), float(l_rel.max()), worst


@pytest.mark.parametrize("rows,splits", [(32, 4), (16, 8)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_schedule_model_matches_plain(rows, splits, rate):
    q, k, v, ek, ev, lens = _inputs()
    seed = torch.tensor([99], dtype=torch.int32)
    kw = dict(window=WINDOW, scale=SCALE, seed=seed, rate=rate)
    want, want_stats = rel_attention_plain(q, k, v, ek, ev, lens, **kw,
                                           with_stats=True)
    got, got_stats = k1_schedule(q, k, v, ek, ev, lens, rows=rows,
                                 splits=splits, seed=seed, rate=rate)
    assert float((got - want).abs().max()) <= ATOL
    m_err, l_err, (b, h, i) = _stats_close(got_stats, want_stats)
    assert m_err <= ATOL and l_err <= ATOL, (
        m_err, l_err, (b, h, i), got_stats[b, h, i].tolist(),
        want_stats[b, h, i].tolist())


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_keys_past_len_weigh_exactly_zero_for_valid_rows(rate):
    """A valid row's key at or past len gets exp(-1e4 - max) = 0 exactly,
    so attention over the keys below len alone gives the same rows; the
    schedule with 16-row tiles, whose valid tiles stop at len, agrees."""
    q, k, v, ek, ev, lens = _inputs(1)
    seed = torch.tensor([3], dtype=torch.int32)
    kw = dict(window=WINDOW, scale=SCALE, seed=seed, rate=rate)
    full, stats = rel_attention_plain(q, k, v, ek, ev, lens, **kw,
                                      with_stats=True)
    for b, ln in enumerate(LENGTHS):
        assert bool((torch.exp(MASK_VAL - stats[b, :, :ln, 0]) == 0).all())
        if rate == 0 and ln < T:
            # item b cut to its own length: its keys past len do not exist
            cut = rel_attention_plain(*(a[b:b + 1, :ln] for a in (q, k, v)),
                                      ek, ev, lens[b:b + 1], window=WINDOW,
                                      scale=SCALE)
            assert float((cut[0] - full[b, :ln]).abs().max()) <= ATOL
    got, _ = k1_schedule(q, k, v, ek, ev, lens, rows=16, splits=8, seed=seed,
                         rate=rate)
    assert float((got - full).abs().max()) <= ATOL


def test_masked_rows_closed_form_without_dropout():
    """Without dropout a row at or past len is the mean of v over the T
    keys plus (1/T) times emb_rel_v summed over its band keys in [0, T)."""
    q, k, v, ek, ev, lens = _inputs(2)
    out = rel_attention_plain(q, k, v, ek, ev, lens, window=WINDOW,
                              scale=SCALE)
    for b, ln in enumerate(LENGTHS):
        for i in range(ln, T):
            for h in range(HEADS):
                cols = slice(h * DK, (h + 1) * DK)
                want = v[b, :, cols].sum(0) / T
                for m in range(2 * WINDOW + 1):
                    if 0 <= i + m - WINDOW < T:
                        want = want + ev[m] / T
                assert float((out[b, i, cols] - want).abs().max()) <= ATOL


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_masked_rows_stats_are_mask_value_and_t(rate):
    q, k, v, ek, ev, lens = _inputs(3)
    seed = torch.tensor([7], dtype=torch.int32)
    kw = dict(window=WINDOW, scale=SCALE, seed=seed, rate=rate)
    _, stats = rel_attention_plain(q, k, v, ek, ev, lens, **kw,
                                   with_stats=True)
    _, model = k1_schedule(q, k, v, ek, ev, lens, rows=32, splits=4,
                           seed=seed, rate=rate)
    for b, ln in enumerate(LENGTHS):
        for s in (stats, model):
            assert bool((s[b, :, ln:, 0] == MASK_VAL).all())
            assert bool((s[b, :, ln:, 1] == T).all())


@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_fixed_order_merge_of_split_partials(splits):
    """Online softmax over 8-key groups dealt to ``splits`` partials, each
    with its own (m, l, O), merged split 0 first, equals one softmax·V; the
    merge gives the same bits twice."""
    rng = np.random.default_rng(splits)
    s = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32)) * 4
    s[3, 40:] = MASK_VAL
    vv = torch.from_numpy(rng.standard_normal((64, DK)).astype(np.float32))
    want = torch.softmax(s, 1) @ vv
    want_l = torch.exp(s - s.amax(1, keepdim=True)).sum(1)

    def merged():
        parts = []
        for sp in range(splits):
            m = torch.full((16,), -float("inf"))
            l_ = torch.zeros(16)
            o = torch.zeros(16, DK)
            for j0 in range(8 * sp, 64, 8 * splits):
                x = s[:, j0:j0 + 8]
                m_new = torch.maximum(m, x.amax(1))
                a = torch.exp(m - m_new)
                p = torch.exp(x - m_new[:, None])
                l_ = l_ * a + p.sum(1)
                o = o * a[:, None] + p @ vv[j0:j0 + 8]
                m = m_new
            parts.append((m, l_, o))
        m = parts[0][0]
        for pm, _, _ in parts[1:]:
            m = torch.maximum(m, pm)
        l_ = sum(pl * torch.exp(pm - m) for pm, pl, _ in parts)
        o = sum(po * (torch.exp(pm - m) / l_)[:, None] for pm, _, po in parts)
        return o, l_ * torch.exp(m - s.amax(1))

    (o1, l1), (o2, _) = merged(), merged()
    assert torch.equal(o1, o2)
    assert float((o1 - want).abs().max()) <= ATOL
    assert float(((l1 - want_l).abs() / want_l).max()) <= ATOL


def test_permuted_key_order_makes_the_accumulator_the_a_fragment():
    """m16n8k8 fragments, lane = 4g + c: the accumulator holds d0 (g, 2c),
    d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1); the A operand wants a0
    (g, c), a1 (g+8, c), a2 (g, c+4), a3 (g+8, c+4).  Taking {d0, d2, d1,
    d3} as {a0, a1, a2, a3} is A[:, k] = P[:, PERM[k]]; with V's rows in the
    same order (load_b_pairs: b0 = V[2c][g], b1 = V[2c+1][g]) the product
    is P·V."""
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.random((16, 8)).astype(np.float32))
    vv = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    a = torch.full((16, 8), float("nan"))
    b = torch.full((8, 8), float("nan"))
    for lane in range(32):
        g, c = lane // 4, lane % 4
        d = [p[g, 2 * c], p[g, 2 * c + 1], p[g + 8, 2 * c], p[g + 8, 2 * c + 1]]
        a0, a1, a2, a3 = d[0], d[2], d[1], d[3]
        a[g, c], a[g + 8, c], a[g, c + 4], a[g + 8, c + 4] = a0, a1, a2, a3
        b[c, g], b[c + 4, g] = vv[2 * c, g], vv[2 * c + 1, g]
    assert torch.equal(a, p[:, PERM])
    assert torch.equal(b, vv[PERM])
    assert float((matmul_3xtf32(a, b) - p @ vv).abs().max()) <= ATOL
