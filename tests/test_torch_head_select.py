"""FACADE step 2c in the port: the head-select wrapper's plain version
(what it runs on CPU tensors) against the reference's oracle and its
Pallas kernel in interpret mode, and LeNet's bias fold against the
reference CNN binding's ``head_loss``.

Numpy emulations of the CUDA kernel's two bodies, each in its order of
operations (the kernel itself runs only on the card), are held against the
same two oracles: the FMA body at FACADE's shapes, and the tensor-core
body of the LM regime (bf16) at shapes that cross its tile edges.

Tolerances are the reference kernel tests': 1e-5 in fp32, 5e-2 in bf16
(both sides read the same bf16 values and accumulate in fp32); argmin, the
selection decision, must agree exactly."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import requires_pallas
from repro.configs import facade_paper as ref_configs
from repro.core.bindings import make_binding as ref_make_binding
from repro.kernels.head_select import ops as ref_hs
from repro.kernels.head_select.ref import head_losses_ref as jax_ref
from repro_torch.configs import facade_paper
from repro_torch.core.bindings import make_binding
from repro_torch.kernels.head_select import head_losses, head_losses_ref
from test_kernels import HS_SHAPES

torch.set_num_threads(1)
DTYPES = {"fp32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


def _case(k, t, d, v, seed, n=1, drop=0.1):
    rng = np.random.default_rng(seed)
    feats = (0.5 * rng.normal(size=(n, t, d))).astype(np.float32)
    heads = (0.05 * rng.normal(size=(n, k, d, v))).astype(np.float32)
    labels = rng.integers(0, v, size=(n, t)).astype(np.int32)
    labels[rng.random((n, t)) < drop] = -1
    return feats, heads, labels


# the FACADE path's shape (T = B = 8, D = LeNet's 512 + bias, V = 10) with
# a few nodes
MAIN_SHAPE = (2, 8, 513, 10)
CHUNK = 16          # vocab columns per pass: csrc/head_select.cu's kChunk
WARPS = 8           # warps per block: csrc/head_select.cu's kWarps
LANES = np.arange(32)


def _fma(a, b, c):
    """fp32 ``fmaf``: the product is exact in fp64 and the sum is rounded
    there and then to fp32 (a double rounding, which differs from one
    rounding only on rare ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _butterfly(x, op):
    """The kernel's reductions over the lane pairs (xor 2, 4, 8, 16) of
    ``x [T, 32]``; every lane ends with the same value."""
    for o in (2, 4, 8, 16):
        x = op(x, x[:, LANES ^ o]).astype(np.float32)
    return x[:, 0]


def _emulate_kernel(feats, heads, labels):
    """``csrc/head_select.cu`` in numpy, in its order: lane l of a token's
    warp sums rows d = l, l + 32, ... of each 16-column vocab chunk by fp32
    FMAs; the transposing halving reduction folds the lanes (xor 16, 8, 4,
    2: a lane keeps half its columns and adds its partner's copy of them;
    then xor 1), which leaves column c's total on lanes 2c and 2c + 1; the
    chunk joins an online max / sum-exp / gold-logit triple; tokens go to
    warps in turn, and the warps' sums are added in warp order."""
    n, t, d = feats.shape
    k, v = heads.shape[1], heads.shape[3]
    out = np.zeros((n, k), np.float32)
    col = LANES >> 1
    for node, head in np.ndindex(n, k):
        f, w, y = feats[node], heads[node, head], labels[node]
        m = np.full(t, -np.inf, np.float32)
        s = np.zeros(t, np.float32)
        gold = np.zeros(t, np.float32)
        for v0 in range(0, v, CHUNK):
            vc = min(CHUNK, v - v0)
            acc = np.zeros((t, 32, CHUNK), np.float32)
            for i0 in range(0, d, 32):
                rows = min(32, d - i0)
                acc[:, :rows, :vc] = _fma(f[:, i0:i0 + rows, None],
                                          w[None, i0:i0 + rows, v0:v0 + vc],
                                          acc[:, :rows, :vc])
            half = CHUNK // 2
            while half:
                upper = ((LANES & 2 * half) != 0)[:, None]
                lo, hi = acc[..., :half], acc[..., half:2 * half]
                keep, send = np.where(upper, hi, lo), np.where(upper, lo, hi)
                acc = (keep + send[:, LANES ^ 2 * half]).astype(np.float32)
                half //= 2
            total = (acc[..., 0] + acc[:, LANES ^ 1, 0]).astype(np.float32)
            z = np.where(col < vc, total, -np.inf).astype(np.float32)
            # fmaxf: a NaN drops out of the max; a term at the max is 1
            m_new = np.fmax(m, _butterfly(z, np.fmax))
            e = np.where(col < vc, np.where(z == m_new[:, None], 1,
                                            np.exp(z - m_new[:, None])), 0)
            s = (np.where(m == m_new, s, s * np.exp(m - m_new))
                 + _butterfly(e, np.add)).astype(np.float32)
            m = m_new
            hit = (y >= v0) & (y < v0 + vc)
            at = np.clip(2 * (y - v0), 0, 31)
            gold = np.where(hit, total[np.arange(t), at], gold)
        nll = ((m + np.log(s)).astype(np.float32) - gold).astype(np.float32)
        part_nll = np.zeros(WARPS, np.float32)
        part_cnt = np.zeros(WARPS, np.float32)
        for tok in np.flatnonzero(y >= 0):
            part_nll[tok % WARPS] += nll[tok]
            part_cnt[tok % WARPS] += 1
        total_nll, count = np.float32(0), np.float32(0)
        for i in range(WARPS):
            total_nll += part_nll[i]
            count += part_cnt[i]
        out[node, head] = total_nll / max(count, np.float32(1))
    return out


def _port(feats, heads, labels, tdt):
    return head_losses(torch.from_numpy(feats).to(tdt),
                       torch.from_numpy(heads).to(tdt),
                       torch.from_numpy(labels))


@pytest.mark.parametrize("k,t,d,v", HS_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_the_reference_oracle(k, t, d, v, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    feats, heads, labels = _case(k, t, d, v, seed=k + t, n=2)
    got = _port(feats, heads, labels, tdt).numpy()
    assert got.shape == (2, k) and got.dtype == np.float32
    for i in range(2):
        want = np.asarray(jax_ref(jnp.asarray(feats[i], jdt),
                                  jnp.asarray(heads[i], jdt), labels[i]))
        np.testing.assert_allclose(got[i], want, rtol=tol, atol=tol)
        assert int(np.argmin(got[i])) == int(np.argmin(want))


@requires_pallas
@pytest.mark.parametrize("k,t,d,v", HS_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_version_matches_the_pallas_kernel(k, t, d, v, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    feats, heads, labels = _case(k, t, d, v, seed=7 * k + t)
    mask = (labels[0] >= 0).astype(np.float32)
    want = np.asarray(ref_hs.facade_head_losses(
        jnp.asarray(feats[0], jdt), jnp.asarray(heads[0], jdt),
        np.maximum(labels[0], 0), mask, interpret=True))
    got = _port(feats, heads, labels, tdt).numpy()[0]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert int(np.argmin(got)) == int(np.argmin(want))


def _emulation_case(k, t, d, v, n):
    feats, heads, labels = _case(k, t, d, v, seed=13 * k + d, n=n)
    if (k, t, d, v) == MAIN_SHAPE:
        feats[..., -1] = 1.0                 # LeNet's folded bias
    return feats, heads, labels


@pytest.mark.parametrize("k,t,d,v,n", [s + (1,) for s in HS_SHAPES]
                         + [MAIN_SHAPE + (3,)])
def test_kernel_order_matches_the_reference_oracle(k, t, d, v, n):
    feats, heads, labels = _emulation_case(k, t, d, v, n)
    got = _emulate_kernel(feats, heads, labels)
    for i in range(n):
        want = np.asarray(jax_ref(jnp.asarray(feats[i]),
                                  jnp.asarray(heads[i]), labels[i]))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        assert int(np.argmin(got[i])) == int(np.argmin(want))


@requires_pallas
@pytest.mark.parametrize("k,t,d,v,n", [s + (1,) for s in HS_SHAPES]
                         + [MAIN_SHAPE + (3,)])
def test_kernel_order_matches_the_pallas_kernel(k, t, d, v, n):
    feats, heads, labels = _emulation_case(k, t, d, v, n)
    got = _emulate_kernel(feats, heads, labels)
    for i in range(n):
        want = np.asarray(ref_hs.facade_head_losses(
            jnp.asarray(feats[i]), jnp.asarray(heads[i]),
            np.maximum(labels[i], 0), (labels[i] >= 0).astype(np.float32),
            interpret=True))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        assert int(np.argmin(got[i])) == int(np.argmin(want))


def non_finite_case(seed: int = 21):
    """FACADE-shape inputs (n 4, K 2, T 8, D 513, V 10, the bias folded)
    with non-finite values where an unguarded faulty round puts them:
    node 0 a token of NaN features, node 1 a head of NaN weights, node 2 a
    +inf bias weight in a column none of its labels names (a +inf logit:
    a +inf loss), node 3 a head of +inf weights (+inf and -inf products:
    NaN logits)."""
    feats, heads, labels = _case(*MAIN_SHAPE, seed=seed, n=4, drop=0.0)
    feats[..., -1] = 1.0
    feats[0, 3] = np.nan
    heads[1, 1] = np.nan
    free = sorted(set(range(MAIN_SHAPE[3])) - set(labels[2].tolist()))[0]
    heads[2, 0, -1, free] = np.inf
    heads[3, 1] = np.inf
    return feats, heads, labels


def test_kernel_order_on_non_finite_inputs():
    """The FMA body's order (``fmaxf`` drops a NaN from the running max,
    a term at an infinite max counts 1) against the plain version and the
    reference's oracle on :func:`non_finite_case`: NaN and +inf at the
    same places, the finite losses within 1e-5, and ``torch.argmin`` of
    the kernel's losses the plain version's and ``jnp.argmin`` of the
    oracle's (the first NaN of a row, else the least loss)."""
    feats, heads, labels = non_finite_case()
    with np.errstate(invalid="ignore", over="ignore"):
        got = _emulate_kernel(feats, heads, labels)
    plain = head_losses_ref(torch.from_numpy(feats),
                            torch.from_numpy(heads),
                            torch.from_numpy(labels)).numpy()
    oracle = np.stack([np.asarray(jax_ref(
        jnp.asarray(feats[i]), jnp.asarray(heads[i]), labels[i]))
        for i in range(feats.shape[0])])
    for want in (plain, oracle):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-5)
    assert np.isnan(got[[0, 0, 1, 3], [0, 1, 1, 1]]).all()
    assert np.isposinf(got[2, 0]) and np.isfinite(got[2, 1])
    pick = torch.argmin(torch.from_numpy(got), dim=1)
    assert pick.tolist() == torch.argmin(torch.from_numpy(plain),
                                         dim=1).tolist() == [0, 1, 1, 1]
    assert pick.tolist() == np.asarray(jnp.argmin(oracle, axis=1)).tolist()


def test_kernel_order_keeps_identical_heads_bit_identical():
    feats, heads, labels = _case(1, 8, 513, 10, seed=5, n=3)
    got = _emulate_kernel(feats, np.repeat(heads, 2, axis=1), labels)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


# The tensor-core body (the LM regime): csrc/head_select.cu's kLmBT,
# kLmBV and wgmma's K step; the merge kernel's kMergeThreads
LM_BT, LM_BV, LM_K_STEP = 128, 256, 16
MERGE_THREADS = 256
LOG2E = np.float32(1.4426950408889634)


def _bf16(x):
    """``x`` rounded to bf16 (nearest even) and held in fp32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _fma32(a, b, c):
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _exp2(x):
    return np.exp2(x.astype(np.float64)).astype(np.float32)


def _lm_logits(f, w):
    """``f [T, D] @ w [D, V]`` as the tensor cores accumulate it: exact
    products of bf16 values, summed 16 rows of D at a time (one wgmma
    step) into an fp32 accumulator, the steps in order of D."""
    acc = np.zeros((f.shape[0], w.shape[1]), np.float32)
    for k0 in range(0, f.shape[1], LM_K_STEP):
        acc = (acc + f[:, k0:k0 + LM_K_STEP] @ w[k0:k0 + LM_K_STEP]).astype(
            np.float32)
    return acc


def _lm_split(logits, y, vt0, vt1):
    """One V-split's (max, sum-exp, gold) per token over vocab tiles
    vt0 .. vt1 - 1, in order: a tile's columns past V are -inf; the max is
    ``fmaxf``'s (a NaN dropped); lane q of a row's quad sums exp2 of its
    columns 8 j + 2 q + e (j, then e) after the log2(e) pre-scale, and the
    quad adds (q0 + q1) + (q2 + q3); under an infinite max a term at it
    counts 1, and so does the running sum's factor where the max stays."""
    t, v = logits.shape
    m = np.full(t, -np.inf, np.float32)
    s = np.zeros(t, np.float32)
    gold = np.zeros(t, np.float32)
    for vt in range(vt0, vt1):
        v0, v1 = vt * LM_BV, min(v, (vt + 1) * LM_BV)
        x = np.full((t, LM_BV), -np.inf, np.float32)
        x[:, :v1 - v0] = logits[:, v0:v1]
        m_new = np.fmax(m, np.fmax.reduce(x, axis=1))
        inf = np.isinf(m_new)
        ml = (m_new * LOG2E).astype(np.float32)
        lanes = x.reshape(t, 32, 4, 2).transpose(0, 2, 1, 3).reshape(t, 4, 64)
        p = _exp2(_fma32(lanes, LOG2E, -ml[:, None, None]))
        p = np.where(inf[:, None, None] & (lanes == m_new[:, None, None]),
                     np.float32(1), p)
        part = np.zeros((t, 4), np.float32)
        for i in range(64):
            part = (part + p[..., i]).astype(np.float32)
        se = ((part[:, 0] + part[:, 1]).astype(np.float32)
              + (part[:, 2] + part[:, 3]).astype(np.float32)).astype(
                  np.float32)
        alpha = np.where(inf & (m == m_new), np.float32(1),
                         _exp2(((m - m_new) * LOG2E).astype(np.float32)))
        s = _fma32(s, alpha, se)
        m = m_new
        hit = (y >= v0) & (y < v1)
        gold = np.where(hit, x[np.arange(t), np.clip(y - v0, 0, LM_BV - 1)],
                        gold)
    return m, s, gold


def _emulate_lm_body(feats, heads, labels, splits, logits_fn=None,
                     split_fn=None, bv=LM_BV):
    """The tensor-core body in numpy, in its order, with V cut into (at
    most) ``splits`` ranges of whole vocab tiles as the launch cuts it
    (the card picks the count from its SMs): each split's triples, then the
    merge kernel: per token the splits in index order (log-sum-exp pairs,
    gold logits added), ``max + log(sum) - gold`` summed by thread
    ``token % 256`` in token order, the 256 partial sums added in a
    halving tree, divided by ``max(valid, 1)``. ``logits_fn``, ``split_fn``
    and ``bv`` (a vocab tile's columns) put another tiled body's products
    and fold in place of this one's (the fp32 body shares the merge)."""
    logits_fn = logits_fn or _lm_logits
    split_fn = split_fn or _lm_split
    n, t, _ = feats.shape
    k, v = heads.shape[1], heads.shape[3]
    v_tiles = -(-v // bv)
    per = -(-v_tiles // splits)
    out = np.zeros((n, k), np.float32)
    for node, head in np.ndindex(n, k):
        y = labels[node]
        logits = logits_fn(feats[node], heads[node, head])
        trip = [split_fn(logits, y, vt0, min(v_tiles, vt0 + per))
                for vt0 in range(0, v_tiles, per)]
        m = np.full(t, -np.inf, np.float32)
        s = np.zeros(t, np.float32)
        g = np.zeros(t, np.float32)
        for mb, sb, gb in trip:
            mx = np.fmax(m, mb)
            with np.errstate(invalid="ignore"):
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


# (n, K, T, D, V, splits): T around the 128-token tiles (1, 127, 128, 129),
# D around the 64-row stages and 16-row wgmma steps (8, 64, 72), V around
# the 256-column tiles (8, 248, 256, 264, and 1024 = 4 tiles), one V-split
# and several; the last node's labels are all excluded where n > 1 (0.0).
# V stays at most 512 or a multiple of 512, as the Pallas wrapper needs.
LM_EMULATION_CASES = [(1, 2, 1, 8, 8, 1), (2, 1, 127, 64, 248, 1),
                      (1, 3, 128, 72, 256, 1), (2, 2, 129, 64, 264, 2),
                      (1, 2, 129, 72, 1024, 4), (3, 1, 200, 8, 512, 2)]


def _lm_emulation_case(n, k, t, d, v):
    feats, heads, labels = _case(k, t, d, v, seed=n + 17 * t + d, n=n)
    if n > 1:
        labels[-1] = -1
    return _bf16(feats), _bf16(heads), labels


@pytest.mark.parametrize("n,k,t,d,v,splits", LM_EMULATION_CASES)
def test_lm_body_order_matches_the_reference_oracle(n, k, t, d, v, splits):
    feats, heads, labels = _lm_emulation_case(n, k, t, d, v)
    got = _emulate_lm_body(feats, heads, labels, splits)
    for i in range(n):
        want = np.asarray(jax_ref(jnp.asarray(feats[i]),
                                  jnp.asarray(heads[i]), labels[i]))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        assert int(np.argmin(got[i])) == int(np.argmin(want))
    if n > 1:
        assert (got[-1] == 0.0).all()


@requires_pallas
@pytest.mark.parametrize("n,k,t,d,v,splits", LM_EMULATION_CASES)
def test_lm_body_order_matches_the_pallas_kernel(n, k, t, d, v, splits):
    feats, heads, labels = _lm_emulation_case(n, k, t, d, v)
    got = _emulate_lm_body(feats, heads, labels, splits)
    for i in range(n):
        want = np.asarray(ref_hs.facade_head_losses(
            jnp.asarray(feats[i]), jnp.asarray(heads[i]),
            np.maximum(labels[i], 0), (labels[i] >= 0).astype(np.float32),
            interpret=True))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-5)
        assert int(np.argmin(got[i])) == int(np.argmin(want))


def lm_non_finite_case(seed: int = 23):
    """LM-regime inputs (n 4, K 2, T 40, D 16, V 776, bf16 values) with
    :func:`non_finite_case`'s non-finite values: node 0 a token of NaN
    features, node 1 a head of NaN weights, node 2 a +inf weight on a
    feature that is 1 for every token, in a column none of its labels
    names, node 3 a head of +inf weights (``chip_smoke.py`` checks the
    kernel on the same construction)."""
    feats, heads, labels = _case(2, 40, 16, 776, seed=seed, n=4, drop=0.1)
    feats, heads = _bf16(feats), _bf16(heads)
    labels[0, 3] = 5
    feats[0, 3] = np.nan
    heads[1, 1] = np.nan
    feats[2, :, 0] = 1.0
    free = sorted(set(range(776)) - set(labels[2].tolist()))[0]
    heads[2, 0, 0, free] = np.inf
    heads[3, 1] = np.inf
    return feats, heads, labels


@pytest.mark.parametrize("splits", [1, 2])
def test_lm_body_order_on_non_finite_inputs(splits):
    """The tensor-core body's order on :func:`lm_non_finite_case` against
    the plain version and the reference's oracle, with the FMA body's
    gates: NaN and +inf at the same places, the finite losses within
    1e-5, the argmins [0, 1, 1, 1] (a row's first NaN, else the least
    loss). Before the infinite-max rule, the +inf logit gave NaN (the
    card showed it first)."""
    feats, heads, labels = lm_non_finite_case()
    with np.errstate(invalid="ignore", over="ignore"):
        got = _emulate_lm_body(feats, heads, labels, splits)
    plain = head_losses_ref(torch.from_numpy(feats),
                            torch.from_numpy(heads),
                            torch.from_numpy(labels)).numpy()
    oracle = np.stack([np.asarray(jax_ref(
        jnp.asarray(feats[i]), jnp.asarray(heads[i]), labels[i]))
        for i in range(feats.shape[0])])
    for want in (plain, oracle):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                                   atol=1e-5)
    assert np.isnan(got[[0, 0, 1, 3], [0, 1, 1, 1]]).all()
    assert np.isposinf(got[2, 0]) and np.isfinite(got[2, 1])
    assert torch.argmin(torch.from_numpy(got), dim=1).tolist() == \
        torch.argmin(torch.from_numpy(plain), dim=1).tolist() == [0, 1, 1, 1]


@pytest.mark.parametrize("splits", [1, 3])
def test_lm_body_order_keeps_identical_heads_bit_identical(splits):
    feats, heads, labels = _lm_emulation_case(2, 1, 129, 72, 776)
    got = _emulate_lm_body(feats, np.repeat(heads, 2, axis=1), labels,
                           splits)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


def test_negative_labels_are_excluded():
    feats, heads, labels = _case(2, 64, 32, 128, seed=3, drop=0.0)
    labels[0, :10] = -1
    got = _port(feats, heads, labels, torch.float32).numpy()[0]
    want = np.asarray(jax_ref(jnp.asarray(feats[0]), jnp.asarray(heads[0]),
                              labels[0]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # the mean is over the 54 valid tokens: all-excluded gives 0, not NaN
    labels[:] = -1
    assert _port(feats, heads, labels, torch.float32).abs().max() == 0.0


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_bias_fold_matches_the_cnn_binding_head_loss(smoke):
    """LeNet's ``feats @ w + b`` as the kernel's ``[feats, 1] @ [w; b]``."""
    rcfg, cfg = ref_configs.lenet(smoke), facade_paper.lenet(smoke)
    n, k, t = 3, 2, 8
    d = (cfg.image_size // 8) ** 2 * cfg.width
    rng = np.random.default_rng(11)
    feats = np.abs(rng.normal(size=(n, t, d))).astype(np.float32)
    w = (rng.normal(size=(n, k, d, cfg.n_classes)) / np.sqrt(d)).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(n, k, cfg.n_classes))).astype(np.float32)
    y = rng.integers(0, cfg.n_classes, size=(n, t)).astype(np.int32)
    ref_b = ref_make_binding(rcfg)
    want = np.stack([np.asarray(jax.vmap(
        lambda wk, bk: ref_b.head_loss({"fc": {"w": wk, "b": bk}},
                                       jnp.asarray(feats[i]),
                                       {"y": y[i]}))(w[i], b[i]))
        for i in range(n)])
    f, wt, labels = make_binding(cfg).select_operands(
        torch.from_numpy(feats), {"fc": {"w": torch.from_numpy(w),
                                         "b": torch.from_numpy(b)}},
        {"y": torch.from_numpy(y)})
    assert f.shape == (n, t, d + 1) and wt.shape == (n, k, d + 1,
                                                      cfg.n_classes)
    assert torch.equal(labels, torch.from_numpy(y))
    got = head_losses(f, wt, labels).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.argmin(1), want.argmin(1))


def test_identical_heads_give_exactly_equal_losses():
    feats, heads, labels = _case(1, 8, 33, 10, seed=5, n=4)
    heads = np.repeat(heads, 3, axis=1)                  # k = 3 copies
    got = _port(feats, heads, labels, torch.float32)
    assert torch.equal(got[:, 0], got[:, 1]) and torch.equal(got[:, 0],
                                                             got[:, 2])
    assert torch.argmin(got, dim=1).tolist() == [0, 0, 0, 0]


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    feats, heads, labels = _case(2, 16, 8, 5, seed=1, n=3)
    before = head_losses.launches
    got = _port(feats, heads, labels, torch.float32)
    assert head_losses.launches == before
    want = head_losses_ref(torch.from_numpy(feats), torch.from_numpy(heads),
                           torch.from_numpy(labels))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shapes", [
    ((2, 8, 4), (2, 3, 5, 7), (2, 8)),         # D mismatch
    ((2, 8, 4), (3, 3, 4, 7), (2, 8)),         # n mismatch
    ((2, 8, 4), (2, 3, 4, 7), (2, 9)),         # T mismatch
    ((8, 4), (3, 4, 7), (8,)),                 # no node axis
])
def test_bad_shapes_raise(shapes):
    f, h, y = shapes
    with pytest.raises(ValueError):
        head_losses(torch.zeros(f), torch.zeros(h),
                    torch.zeros(y, dtype=torch.int32))
