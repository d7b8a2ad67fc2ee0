"""FACADE step 2c in fp32 on the tensor cores: a numpy model of the
head-select CUDA kernel's fourth body (``fp32_tensor_core``, 3xTF32) in
its order of operations (the kernel itself runs only on the card), held
against the reference's oracle (``repro.kernels.head_select.ref``) and its
Pallas kernel in interpret mode at 1e-5, as ``test_torch_head_select_wide``
holds the other tiled bodies:

- the split: x = big + small, big = x rounded to TF32 (to nearest, ties
  away; truncated where that passes FLT_MAX), small = the rest rounded the
  same way; a non-finite x whole in small, big 0;
- the products: the features and heads split, D zero-filled to the 32-row
  stages, per 8-deep k-step three products into the tensor cores' fp32
  accumulator in order (small head × big features, big head × small
  features, big × big), restarted each stage, whose sums are added to
  nearest into a second accumulator in the order of D; each product's 8
  terms summed exactly and added to the tensor cores' accumulator
  truncated toward zero (a model of the tensor core's sum, whose inner
  order the card does not document; truncation fits the card's readings,
  ``_tc_logits``);
- the fold: a 128-column vocab tile in two consumers of 64 columns, a
  consumer's column of logits over 4 warps × 8 lanes × 2 rows in the
  kernel's permutation, exp2 terms summed a lane's pair, then over the 8
  lanes in a butterfly, then the 4 warps in order; each consumer's triple
  a V-split, merged in (split, consumer) order by the tensor-core body's
  merge.

It also runs on non-finite inputs, on bit-identical heads and against a
float64 witness at D 2048, where its distance must stay within
``chip_smoke.HS_TC32_FACTOR`` times the plain fp32 version's own distance,
as the card's gate holds the kernel.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import requires_pallas
from repro_torch.kernels.head_select import head_losses_ref
from test_torch_head_select import LOG2E, MERGE_THREADS, _exp2, _fma32
from test_torch_head_select_wide import (_f32_case, _hold, _oracle,
                                         _pallas, non_finite_case)
from torch_caps import chip_smoke_constant

torch.set_num_threads(1)

# csrc/head_select.cu: kTcBV (a vocab tile), a consumer's 64 columns (the
# wgmma's M), kTcBK (D per stage) and the wgmma's depth
TC_BV = 128
TC_M = 64
TC_BK = 32
TC_K = 8
# a consumer's column held by warp w, lane row g, accumulator half h: the
# kernel's permutation (col[h] in head_losses_f32tc_kernel)
TC_COLS = np.array([[[32 * (w // 2) + 4 * (2 * (w % 2) + h + 4 * (g // 4))
                      + g % 4 for h in range(2)] for g in range(8)]
                    for w in range(4)])
def _rna(bits):
    """TF32 words of fp32 bit patterns: to nearest, ties away from zero,
    the low 13 bits cleared."""
    return ((bits.astype(np.uint64) + 0x1000) & 0xffffe000).astype(np.uint32)


def tf32_split(x):
    """(big, small) as the kernel's ``tf32_split`` gives them."""
    x = np.ascontiguousarray(x, np.float32)
    fin = np.isfinite(x)
    bits = np.where(fin, x, 0).astype(np.float32).view(np.uint32)
    big = _rna(bits).view(np.float32)
    over = ~np.isfinite(big)                         # rounded past FLT_MAX
    big = np.where(over, (bits & 0xffffe000).view(np.float32), big)
    rest = (np.where(fin, x, 0) - big).astype(np.float32)   # exact
    small = _rna(rest.view(np.uint32)).view(np.float32)
    small = np.where(fin, small, np.where(np.isnan(x), np.float32(np.nan),
                                          x)).astype(np.float32)
    return big.astype(np.float32), small


def _toward_zero(x):
    """float64 to float32, rounded toward zero."""
    f = x.astype(np.float32)
    with np.errstate(invalid="ignore"):
        past = np.abs(f.astype(np.float64)) > np.abs(x)
    return np.where(past, np.nextafter(f, np.float32(0)), f)


def _tc_logits(f, w, promote=True):
    """``f [T, D] @ w [D, V]`` as the fp32 tensor-core body computes the
    logits (module docstring); without ``promote`` one accumulator runs
    over all of D, as the body's first build did, which failed the card's
    witness gate at D 1600 and 2048
    (``test_the_sum_restarted_each_stage_keeps_fp32_s_accuracy``)."""
    (t, d), v = f.shape, w.shape[1]
    dp = -(-d // TC_BK) * TC_BK
    fb, fs = tf32_split(np.pad(f, ((0, 0), (0, dp - d))))
    hb, hs = tf32_split(np.pad(w, ((0, dp - d), (0, 0))))
    acc = np.zeros((t, v), np.float32)
    total = np.zeros((t, v), np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for k0 in range(0, dp, TC_K):
            if promote and k0 % TC_BK == 0:
                total = (total + acc).astype(np.float32)
                acc = np.zeros((t, v), np.float32)
            sl = slice(k0, k0 + TC_K)
            for a, b in ((hs, fb), (hb, fs), (hb, fb)):
                acc = _toward_zero(acc.astype(np.float64)
                                   + b[:, sl].astype(np.float64)
                                   @ a[sl].astype(np.float64))
        return (total + acc).astype(np.float32)


def _term(z, m):
    """The kernel's ``tc_term``: exp(z - m) as exp2 after the log2(e)
    pre-scale; 1 at a +inf max, a -inf column 0 and a NaN NaN under a -inf
    max."""
    m = m[:, None, None, None]
    ml = (m * LOG2E).astype(np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        p = _exp2(_fma32(z, LOG2E, -ml))
    p = np.where((m == np.inf) & (z == m), np.float32(1), p)
    return np.where(m == -np.inf, np.where(z == m, np.float32(0), z),
                    p).astype(np.float32)


def _tree8(x):
    """The butterfly over the 8 lane rows of a quad column (xor 4, 8, 16):
    pairs first."""
    while x.shape[-1] > 1:
        x = (x[..., 0::2] + x[..., 1::2]).astype(np.float32)
    return x[..., 0]


def _consumer(logits, y, vt0, vt1, c):
    """Consumer ``c``'s (max, sum-exp, gold) per token over its 64 columns
    of the 128-column vocab tiles vt0 .. vt1 - 1, in order."""
    t, v = logits.shape
    m = np.full(t, -np.inf, np.float32)
    s = np.zeros(t, np.float32)
    gold = np.zeros(t, np.float32)
    for vt in range(vt0, vt1):
        c0 = vt * TC_BV + TC_M * c
        cols = c0 + TC_COLS                                   # [4, 8, 2]
        z = np.full((t,) + cols.shape, -np.inf, np.float32)
        ok = cols < v
        z[:, ok] = logits[:, cols[ok]]
        m_new = np.fmax(m, np.fmax.reduce(z.reshape(t, -1), axis=1))
        pair = (_term(z, m_new)[..., 0] + _term(z, m_new)[..., 1]
                ).astype(np.float32)                          # [T, 4, 8]
        warps = _tree8(pair)                                  # [T, 4]
        se = warps[:, 0]
        for w in range(1, 4):
            se = (se + warps[:, w]).astype(np.float32)
        with np.errstate(invalid="ignore"):
            alpha = np.where(m == m_new, np.float32(1),
                             _exp2(((m - m_new) * LOG2E).astype(np.float32)))
        s = _fma32(s, alpha, se)
        m = m_new
        hit = (y >= c0) & (y < c0 + TC_M)
        gold = np.where(hit, logits[np.arange(t), np.clip(y, 0, v - 1)],
                        gold)
    return m, s, gold


def emulate_tc32_body(feats, heads, labels, splits):
    """The fp32 tensor-core body in numpy, in its order: V cut into (at
    most) ``splits`` ranges of whole 128-column tiles, each split's two
    consumers' triples, then the merge kernel over the (split, consumer)
    entries in index order (``_emulate_lm_body``'s merge): log-sum-exp
    pairs, gold logits added, ``max + log(sum) - gold`` summed by thread
    ``token % 256`` in token order, the partial sums in a halving tree,
    divided by ``max(valid, 1)``."""
    n, t, _ = feats.shape
    k, v = heads.shape[1], heads.shape[3]
    v_tiles = -(-v // TC_BV)
    per = -(-v_tiles // splits)
    out = np.zeros((n, k), np.float32)
    for node, head in np.ndindex(n, k):
        y = labels[node]
        logits = _tc_logits(feats[node], heads[node, head])
        entries = [_consumer(logits, y, vt0, min(v_tiles, vt0 + per), c)
                   for vt0 in range(0, v_tiles, per) for c in range(2)]
        m = np.full(t, -np.inf, np.float32)
        s = np.zeros(t, np.float32)
        g = np.zeros(t, np.float32)
        for mb, sb, gb in entries:
            mx = np.fmax(m, mb)
            with np.errstate(invalid="ignore", over="ignore"):
                s = np.where(mx == -np.inf, s, (
                    np.where(m == mx, s,
                             s * np.exp(m - mx).astype(np.float32))
                    + np.where(mb == mx, sb,
                               sb * np.exp(mb - mx).astype(np.float32))
                ).astype(np.float32))
            m = mx
            g = (g + gb).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            nll = ((m + np.log(s)).astype(np.float32) - g).astype(np.float32)
        valid = y >= 0
        nll = np.where(valid, nll, np.float32(0))
        pad = -t % MERGE_THREADS
        part_nll = np.zeros(MERGE_THREADS, np.float32)
        part_cnt = np.zeros(MERGE_THREADS, np.float32)
        for row_nll, row_cnt in zip(
                np.pad(nll, (0, pad)).reshape(-1, MERGE_THREADS),
                np.pad(valid, (0, pad)).reshape(-1, MERGE_THREADS)):
            part_nll = (part_nll + row_nll).astype(np.float32)
            part_cnt = (part_cnt + row_cnt).astype(np.float32)
        stride = MERGE_THREADS // 2
        while stride:
            part_nll[:stride] += part_nll[stride:2 * stride]
            part_cnt[:stride] += part_cnt[stride:2 * stride]
            stride //= 2
        out[node, head] = part_nll[0] / max(part_cnt[0], np.float32(1))
    return out


def test_the_permutation_covers_a_consumer_s_columns_once():
    assert sorted(TC_COLS.ravel().tolist()) == list(range(TC_M))


def test_a_fragment_load_hits_32_distinct_banks():
    """Lane (g, q) of warp w loads k-step rows q and q + 4 of its 16
    columns from a 128-byte-swizzled box (16-byte chunk c of row r at
    chunk c ^ (r % 8)): a0 and a1 (row q, halves 0 and 1) and a2 and a3
    (row q + 4) each hit 32 distinct banks."""
    for w in range(4):
        for hi in range(2):
            for h in range(2):
                banks = set()
                for g in range(8):
                    for q in range(4):
                        row, col = q + 4 * hi, TC_COLS[w, g, h] % 32
                        banks.add(((col // 4) ^ row) * 4 + col % 4)
                assert len(banks) == 32


def test_tf32_split():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.standard_normal(1000).astype(np.float32),
                        np.float32([0.0, -0.0, 1.0, 3.0e38, -3.4028235e38,
                                    np.float32(2 ** -126), 1e-40])])
    big, small = tf32_split(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & 0x1fff).any()
    rel = np.abs((big.astype(np.float64) + small) - x) / np.maximum(
        np.abs(x.astype(np.float64)), 1e-30)
    assert (rel[:1000] <= 2.0 ** -21).all()
    # -FLT_MAX rounds past it: truncated, finite
    assert np.isfinite(big).all() and np.isfinite(small).all()
    assert abs(float(big[-3]) + 3.4028235e38) <= 3.4028235e38 * 2.0 ** -10
    big, small = tf32_split(np.float32([np.inf, -np.inf, np.nan]))
    assert (big == 0).all()
    assert small[0] == np.inf and small[1] == -np.inf and np.isnan(small[2])


# (n, K, T, D, V, splits): T around the 128-token tiles (1, 127, 129, 130,
# 200), D around the 8-deep k-steps, the 4-value pad of the feature planes
# and the 32-row stages (5, 16, 17, 33, 64, 70), V around the 128-column
# tiles and the 64-column consumers (128; 129 and 190: the second tile's
# second consumer past V; 383, 512), one split and several; the last
# node's labels all excluded where n > 1 (0.0).
TC_CASES = [(1, 2, 1, 16, 128, 1), (2, 1, 127, 17, 129, 2),
            (1, 3, 129, 33, 190, 2), (2, 2, 200, 64, 383, 3),
            (3, 1, 130, 5, 512, 4), (2, 1, 40, 70, 300, 1)]


@pytest.mark.parametrize("n,k,t,d,v,splits", TC_CASES)
def test_tc32_body_order_matches_the_reference_oracle(n, k, t, d, v,
                                                      splits):
    feats, heads, labels = _f32_case(n, k, t, d, v)
    got = emulate_tc32_body(feats, heads, labels, splits)
    _hold(got, _oracle(feats, heads, labels))
    if n > 1:
        assert (got[-1] == 0.0).all()


@requires_pallas
@pytest.mark.parametrize("n,k,t,d,v,splits", TC_CASES[1:4])
def test_tc32_body_order_matches_the_pallas_kernel(n, k, t, d, v, splits):
    feats, heads, labels = _f32_case(n, k, t, d, v)
    _hold(emulate_tc32_body(feats, heads, labels, splits),
          _pallas(feats, heads, labels))


@pytest.mark.parametrize("splits", [1, 2])
def test_tc32_order_on_non_finite_inputs(splits):
    """NaN and +inf at the plain version's and the oracle's places (the
    +inf weight times a feature of 1, exact in TF32: +inf, not inf 0 =
    NaN), the finite losses within 1e-5, the argmins [0, 1, 1, 1]."""
    feats, heads, labels = non_finite_case(18, 300, bf16=False)
    with np.errstate(invalid="ignore", over="ignore"):
        got = emulate_tc32_body(feats, heads, labels, splits)
    plain = head_losses_ref(torch.from_numpy(feats),
                            torch.from_numpy(heads),
                            torch.from_numpy(labels)).numpy()
    for want in (plain, _oracle(feats, heads, labels)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-5)
    assert np.isnan(got[[0, 0, 1, 3], [0, 1, 1, 1]]).all()
    assert np.isposinf(got[2, 0]) and np.isfinite(got[2, 1])
    assert torch.argmin(torch.from_numpy(got), dim=1).tolist() == \
        torch.argmin(torch.from_numpy(plain), dim=1).tolist() == [0, 1, 1, 1]


def test_the_sum_restarted_each_stage_keeps_fp32_s_accuracy():
    """Why the body adds the tensor cores' sum of each 32-row stage into a
    second accumulator: with the sum truncated toward zero at each step,
    one accumulator over D 2048's 768 steps puts the logits more than ten
    times farther from float64 than the plain fp32 product, and the sum
    restarted each stage within twice its distance."""
    rng = np.random.default_rng(3)
    f = rng.standard_normal((16, 2048)).astype(np.float32)
    w = (0.02 * rng.standard_normal((2048, 64))).astype(np.float32)
    exact = f.astype(np.float64) @ w.astype(np.float64)
    plain = np.abs((torch.from_numpy(f) @ torch.from_numpy(w)).numpy()
                   - exact).max()
    once = np.abs(_tc_logits(f, w, promote=False) - exact).max()
    staged = np.abs(_tc_logits(f, w) - exact).max()
    assert once > 10 * plain and staged < 2 * plain, (once, staged, plain)


def test_an_infinite_weight_on_an_exact_feature_is_infinite():
    """The split that keeps a +inf weight out of big: its products with a
    feature exact in TF32 (small 0) are +inf, while an inf in big would
    give big x small = inf 0 = NaN."""
    f = np.float32([[1.0, 2.0, 0.5]])
    w = np.zeros((3, 2), np.float32)
    w[0, 0] = np.inf
    w[1, 1] = -np.inf
    got = _tc_logits(f, w)
    assert got[0, 0] == np.inf and got[0, 1] == -np.inf


@pytest.mark.parametrize("splits", [1, 3])
def test_tc32_order_keeps_identical_heads_bit_identical(splits):
    feats, heads, labels = _f32_case(2, 1, 129, 33, 300)
    got = emulate_tc32_body(feats, np.repeat(heads, 2, axis=1), labels,
                            splits)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


def _witness(feats, heads, labels):
    """The function in float64 (the plain version's steps)."""
    f, h = torch.from_numpy(feats).double(), torch.from_numpy(heads).double()
    lab = torch.from_numpy(labels)
    n, k = h.shape[:2]
    t = f.shape[1]
    logits = torch.einsum("ntd,nkdv->nktv", f, h)
    lse = torch.logsumexp(logits, dim=-1)
    labs = lab.long().clamp(min=0)[:, None, :, None].expand(n, k, t, 1)
    gold = torch.gather(logits, -1, labs).squeeze(-1)
    valid = (lab >= 0)[:, None, :]
    nll = torch.where(valid, lse - gold, torch.zeros_like(lse))
    return (nll.sum(-1) / valid.sum(-1).clamp(min=1)).numpy()


def _distance(got, want):
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1)))


@pytest.mark.parametrize("seed", [0, 1])
def test_tc32_order_against_a_float64_witness(seed):
    """At D 2048 with features at unit scale and heads at 0.02 and 0.05
    (as an LM's normed stream and head give them), the model's distance
    from the float64 witness is within ``HS_TC32_FACTOR`` times the plain
    fp32 version's (the control), or within ``HS_TC32_FLOOR``, as on the
    card."""
    rng = np.random.default_rng(seed)
    n, k, t, d, v = 2, 2, 48, 2048, 300
    feats = rng.standard_normal((n, t, d)).astype(np.float32)
    heads = ((0.02, 0.05)[seed] * rng.standard_normal((n, k, d, v))
             ).astype(np.float32)
    labels = rng.integers(0, v, (n, t)).astype(np.int32)
    witness = _witness(feats, heads, labels)
    plain = head_losses_ref(torch.from_numpy(feats), torch.from_numpy(heads),
                            torch.from_numpy(labels)).numpy()
    got = emulate_tc32_body(feats, heads, labels, 2)
    e_model, e_plain = _distance(got, witness), _distance(plain, witness)
    assert e_model <= max(chip_smoke_constant("HS_TC32_FACTOR") * e_plain,
                          chip_smoke_constant("HS_TC32_FLOOR")), (e_model,
                                                                   e_plain)
