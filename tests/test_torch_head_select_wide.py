"""FACADE step 2c at an LM's dtypes and vocabularies: numpy models of the
head-select CUDA kernel's two wider paths, each in its order of operations
(the kernel itself runs only on the card), held against the reference's
oracle (``repro.kernels.head_select.ref``) and its Pallas kernel in
interpret mode at 1e-5, as ``test_torch_head_select.py`` holds the FMA
and tensor-core bodies:

- the fp32 tiled body: 128-token × 128-column tiles, each logit one fp32
  FMA chain in the order of D (zero-filled past D, T and V), the fold of
  a tile over the 16 lanes of a half warp (8 columns a lane), V-splits and
  the tensor-core body's merge;
- the tensor-core body on a ragged D or V: the launcher copies the
  features (D) or heads (V) into rows padded to a multiple of 8, and the
  tensor maps keep the logical extent, so TMA fills past D and V with
  zeros and the pad is never read (stale memory in the pad stands in as
  NaN here).

The Pallas kernel needs V to divide its vocab block, so it runs here with
``block_v = V`` at a ragged V. Both models also run on non-finite inputs
and on bit-identical heads, and the wrapper's dispatch rule (``body_for``,
the mirror of the source's ``hs_body``) is held on every shape the CNN and
LM paths give it."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import requires_pallas
from repro.kernels.head_select import ops as ref_hs
from repro.kernels.head_select.ref import head_losses_ref as jax_ref
from repro_torch import configs  # noqa: F401  (registers the archs)
from repro_torch.kernels.head_select import head_losses, head_losses_ref
from repro_torch.kernels.head_select.ops import BODIES, body_for
from repro_torch.models.base import get_config, list_archs
from test_kernels import HS_SHAPES
from test_torch_head_select import (LM_BV, LM_K_STEP, LOG2E, _bf16, _case,
                                    _emulate_lm_body, _exp2, _fma32)

torch.set_num_threads(1)
TOL = 1e-5

# csrc/head_select.cu: the fp32 body's vocab tile (kF32BV) and the
# tensor-core body's D stage (kLmBD)
F32_BV = 128
LM_BD = 64
# a lane's columns in an fp32 vocab tile: lane tx of a half warp holds
# 4 tx + c + 64 h, in the order j = 4 h + c
F32_COLS = np.array([[4 * tx + (j & 3) + 64 * (j >> 2) for j in range(8)]
                     for tx in range(16)])


def _f32_logits(f, w):
    """``f [T, D] @ w [D, V]`` as the fp32 body computes each logit: one
    ``fmaf`` chain in the order of d (the zero-filled rows past D add
    exact zeros)."""
    acc = np.zeros((f.shape[0], w.shape[1]), np.float32)
    for i in range(f.shape[1]):
        acc = _fma32(f[:, i, None], w[None, i], acc)
    return acc


def _tree16(x):
    """The butterfly sum over a half warp's 16 lanes (xor 1, 2, 4, 8):
    lane order, pairs first."""
    while x.shape[1] > 1:
        x = (x[:, 0::2] + x[:, 1::2]).astype(np.float32)
    return x[:, 0]


def _f32_split(logits, y, vt0, vt1):
    """One V-split's (max, sum-exp, gold) per token over the fp32 body's
    128-column vocab tiles vt0 .. vt1 - 1, in order: columns past V are
    -inf; the max is ``fmaxf``'s; each lane sums exp2 of its 8 columns
    (:data:`F32_COLS`, in order) after the log2(e) pre-scale, the half warp
    adds the lanes' sums in a butterfly; under an infinite max a term at it
    counts 1, and so does the running sum's factor where the max stays; the
    gold logit is the label's column, summed with zeros."""
    t, v = logits.shape
    m = np.full(t, -np.inf, np.float32)
    s = np.zeros(t, np.float32)
    gold = np.zeros(t, np.float32)
    for vt in range(vt0, vt1):
        v0, v1 = vt * F32_BV, min(v, (vt + 1) * F32_BV)
        x = np.full((t, F32_BV), -np.inf, np.float32)
        x[:, :v1 - v0] = logits[:, v0:v1]
        lanes = x[:, F32_COLS]                                # [T, 16, 8]
        m_new = np.fmax(m, np.fmax.reduce(x, axis=1))
        inf = np.isinf(m_new)
        ml = (m_new * LOG2E).astype(np.float32)
        p = _exp2(_fma32(lanes, LOG2E, -ml[:, None, None]))
        p = np.where(inf[:, None, None] & (lanes == m_new[:, None, None]),
                     np.float32(1), p)
        part = np.zeros((t, 16), np.float32)
        for j in range(8):
            part = (part + p[..., j]).astype(np.float32)
        alpha = np.where(inf & (m == m_new), np.float32(1),
                         _exp2(((m - m_new) * LOG2E).astype(np.float32)))
        s = _fma32(s, alpha, _tree16(part))
        m = m_new
        hit = (y >= v0) & (y < v1)
        gold = np.where(hit, x[np.arange(t), np.clip(y - v0, 0, F32_BV - 1)],
                        gold)
    return m, s, gold


def emulate_f32_body(feats, heads, labels, splits):
    """The fp32 tiled body in numpy, in its order, V cut into (at most)
    ``splits`` ranges of whole 128-column tiles, then the merge kernel of
    the tensor-core body (``_emulate_lm_body``'s)."""
    return _emulate_lm_body(feats, heads, labels, splits,
                            logits_fn=_f32_logits, split_fn=_f32_split,
                            bv=F32_BV)


def _padded(x, width):
    """``x [rows, cols]`` copied into rows of ``width`` values
    (``head_losses_pad_kernel``; its pad holds NaN here, as stale memory
    the map must never read)."""
    out = np.full((x.shape[0], width), np.nan, np.float32)
    out[:, :x.shape[1]] = x
    return out


def _box(buf, extent, c0, c1):
    """Columns c0 .. c1 - 1 of a padded buffer as a tensor map of inner
    extent ``extent`` reads them: zeros at and past the extent."""
    out = np.zeros((buf.shape[0], c1 - c0), np.float32)
    if c0 < extent:
        out[:, :min(c1, extent) - c0] = buf[:, c0:min(c1, extent)]
    return out


def _padded_lm_logits(f, w):
    """The tensor-core body's products on a ragged D or V: the features
    and head copied into rows of D8 and V8 values, each D stage's boxes
    read through maps of logical extent D (features) and (V, D) (head),
    zero past them, each wgmma step's 16 rows of D summed into the fp32
    accumulator in order."""
    (t, d), v = f.shape, w.shape[1]
    d8, v8 = -(-d // 8) * 8, -(-v // 8) * 8
    fbuf, wbuf = _padded(f, d8), _padded(w, v8)
    v_cols = -(-v // LM_BV) * LM_BV
    acc = np.zeros((t, v_cols), np.float32)
    for k0 in range(0, -(-d // LM_BD) * LM_BD, LM_K_STEP):
        a = _box(fbuf, d, k0, k0 + LM_K_STEP)                 # [T, 16]
        rows = np.zeros((LM_K_STEP, v8), np.float32)          # past D: 0
        rows[:max(0, min(d - k0, LM_K_STEP))] = wbuf[k0:min(d, k0 +
                                                            LM_K_STEP)]
        b = _box(rows, v, 0, v_cols)                          # [16, V']
        acc = (acc + a @ b).astype(np.float32)
    if np.isfinite(f).all() and np.isfinite(w).all():
        assert not np.isnan(acc).any(), "the pad was read"
    return acc[:, :v]


def emulate_padded_lm_body(feats, heads, labels, splits):
    """The tensor-core body on a ragged D or V (the copy, the maps'
    extents, then its fold and merge) in numpy, in its order."""
    return _emulate_lm_body(feats, heads, labels, splits,
                            logits_fn=_padded_lm_logits)


def _oracle(feats, heads, labels):
    return np.stack([np.asarray(jax_ref(jnp.asarray(feats[i]),
                                        jnp.asarray(heads[i]), labels[i]))
                     for i in range(feats.shape[0])])


def _pallas(feats, heads, labels):
    """The Pallas kernel in interpret mode, node by node; ``block_v = V``
    (it needs V to divide its vocab block)."""
    return np.stack([np.asarray(ref_hs.facade_head_losses(
        jnp.asarray(feats[i]), jnp.asarray(heads[i]),
        np.maximum(labels[i], 0), (labels[i] >= 0).astype(np.float32),
        block_v=heads.shape[3], interpret=True))
        for i in range(feats.shape[0])])


def _hold(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.argmin(1), want.argmin(1))


# (n, K, T, D, V, splits) for the fp32 body: T around its 128-token tiles
# (1, 127, 129, 130, 200), D around its 16-row chunks (5, 16, 17, 33, 64;
# 5 and 17 take 4-byte copies on the card), V around its 128-column tiles
# (128, 129 with one column in its second tile, 256, 383, 512), one split
# and several; the last node's labels all excluded where n > 1 (0.0).
F32_CASES = [(1, 2, 1, 16, 128, 1), (2, 1, 127, 17, 129, 2),
             (1, 3, 129, 33, 256, 2), (2, 2, 200, 64, 383, 3),
             (3, 1, 130, 5, 512, 4)]
# ... and for the tensor-core body on a ragged V (249, 1001: one and four
# 256-column tiles, the last ragged) and D (36, 70: off its 8-value rows
# and 64-row stages), bf16 values
PADDED_CASES = [(1, 2, 130, 64, 249, 1), (2, 1, 129, 36, 1001, 2),
                (1, 2, 127, 70, 1001, 4), (3, 1, 64, 24, 257, 1)]


def _f32_case(n, k, t, d, v):
    feats, heads, labels = _case(k, t, d, v, seed=31 * n + 7 * t + d, n=n)
    if n > 1:
        labels[-1] = -1
    return feats, heads, labels


def _padded_case(n, k, t, d, v):
    feats, heads, labels = _case(k, t, d, v, seed=29 * n + 5 * t + d, n=n)
    if n > 1:
        labels[-1] = -1
    return _bf16(feats), _bf16(heads), labels


@pytest.mark.parametrize("n,k,t,d,v,splits", F32_CASES)
def test_f32_body_order_matches_the_reference_oracle(n, k, t, d, v, splits):
    feats, heads, labels = _f32_case(n, k, t, d, v)
    got = emulate_f32_body(feats, heads, labels, splits)
    _hold(got, _oracle(feats, heads, labels))
    if n > 1:
        assert (got[-1] == 0.0).all()


@requires_pallas
@pytest.mark.parametrize("n,k,t,d,v,splits", F32_CASES[1:4])
def test_f32_body_order_matches_the_pallas_kernel(n, k, t, d, v, splits):
    feats, heads, labels = _f32_case(n, k, t, d, v)
    _hold(emulate_f32_body(feats, heads, labels, splits),
          _pallas(feats, heads, labels))


@pytest.mark.parametrize("n,k,t,d,v,splits", PADDED_CASES)
def test_padded_lm_body_order_matches_the_reference_oracle(n, k, t, d, v,
                                                           splits):
    feats, heads, labels = _padded_case(n, k, t, d, v)
    got = emulate_padded_lm_body(feats, heads, labels, splits)
    _hold(got, _oracle(feats, heads, labels))
    if n > 1:
        assert (got[-1] == 0.0).all()


@requires_pallas
@pytest.mark.parametrize("n,k,t,d,v,splits", PADDED_CASES[:3])
def test_padded_lm_body_order_matches_the_pallas_kernel(n, k, t, d, v,
                                                        splits):
    feats, heads, labels = _padded_case(n, k, t, d, v)
    _hold(emulate_padded_lm_body(feats, heads, labels, splits),
          _pallas(feats, heads, labels))


def test_the_padded_model_reads_no_pad():
    """The padded model's maps keep the logical extents: read through maps
    as wide as the padded rows, the NaN pad reaches every logit."""
    feats, heads, _ = _padded_case(1, 1, 8, 36, 249)
    assert not np.isnan(_padded_lm_logits(feats[0], heads[0, 0])).any()
    fbuf = _padded(feats[0], 40)
    assert np.isnan(_box(fbuf, 40, 32, 48) @ np.ones((16, 1))).all()


def non_finite_case(d, v, *, bf16, seed=41):
    """n 4, K 2, T 40 with the non-finite values an unguarded faulty round
    gives (as ``test_torch_head_select.lm_non_finite_case`` places them):
    node 0 a token of NaN features, node 1 a head of NaN weights, node 2 a
    +inf weight on a feature that is 1 for every token, in a column none of
    its labels names (a +inf logit: a +inf loss), node 3 a head of +inf
    weights (NaN logits)."""
    feats, heads, labels = _case(2, 40, d, v, seed=seed, n=4, drop=0.1)
    if bf16:
        feats, heads = _bf16(feats), _bf16(heads)
    labels[0, 3] = 5
    feats[0, 3] = np.nan
    heads[1, 1] = np.nan
    feats[2, :, 0] = 1.0
    free = sorted(set(range(v)) - set(labels[2].tolist()))[0]
    heads[2, 0, 0, free] = np.inf
    heads[3, 1] = np.inf
    return feats, heads, labels


@pytest.mark.parametrize("body,splits", [("fp32_tiled", 1),
                                         ("fp32_tiled", 2),
                                         ("tensor_core", 1),
                                         ("tensor_core", 2)])
def test_orders_on_non_finite_inputs(body, splits):
    """NaN and +inf at the plain version's and the oracle's places, the
    finite losses within 1e-5, the argmins [0, 1, 1, 1] (a row's first
    NaN, else the least loss): the fp32 body at D 18, V 300 and the padded
    tensor-core body at D 18, V 777."""
    fp32 = body == "fp32_tiled"
    feats, heads, labels = non_finite_case(18, 300 if fp32 else 777,
                                           bf16=not fp32)
    emulate = emulate_f32_body if fp32 else emulate_padded_lm_body
    with np.errstate(invalid="ignore", over="ignore"):
        got = emulate(feats, heads, labels, splits)
    plain = head_losses_ref(torch.from_numpy(feats),
                            torch.from_numpy(heads),
                            torch.from_numpy(labels)).numpy()
    for want in (plain, _oracle(feats, heads, labels)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=TOL, atol=TOL)
    assert np.isnan(got[[0, 0, 1, 3], [0, 1, 1, 1]]).all()
    assert np.isposinf(got[2, 0]) and np.isfinite(got[2, 1])
    assert torch.argmin(torch.from_numpy(got), dim=1).tolist() == \
        torch.argmin(torch.from_numpy(plain), dim=1).tolist() == [0, 1, 1, 1]


@pytest.mark.parametrize("body,splits", [("fp32_tiled", 1),
                                         ("fp32_tiled", 3),
                                         ("tensor_core", 2)])
def test_orders_keep_identical_heads_bit_identical(body, splits):
    if body == "fp32_tiled":
        feats, heads, labels = _f32_case(2, 1, 129, 33, 300)
        emulate = emulate_f32_body
    else:
        feats, heads, labels = _padded_case(2, 1, 129, 36, 777)
        emulate = emulate_padded_lm_body
    got = emulate(feats, np.repeat(heads, 2, axis=1), labels, splits)
    np.testing.assert_array_equal(got[:, 0], got[:, 1])


def _path_shapes():
    """(label, (n, K, T, D, V), dtype, the body) of every step 2c the CNN
    and LM paths give K1: GN-LeNet's FACADE path (32 nodes, K 2, B 8, D
    512 + bias, V 10) in fp32 and bf16, a node-mesh rank's 8 nodes,
    ResNet8's one stream per (node, head) (n·K 64, D 64 + bias, V 41); the
    reference tests' ``HS_SHAPES`` in both dtypes; every arch's LM
    FACADE step 2c (n·K 4, T = B·S 1024) at full width in its bf16 and in
    fp32 (D 384 to 7,168: the fp32 tensor cores), and its smoke config
    (fp32, V 512; D 256 the fp32 tensor cores, whisper-tiny's D 128 the
    SIMT body)."""
    out = [("lenet", (32, 2, 8, 513, 10), torch.float32, "fma"),
           ("lenet bf16", (32, 2, 8, 513, 10), torch.bfloat16, "fma"),
           ("node rank", (8, 2, 8, 513, 10), torch.float32, "fma"),
           ("resnet8", (64, 1, 8, 65, 41), torch.float32, "fma")]
    for k, t, d, v in HS_SHAPES:
        out += [("hs", (1, k, t, d, v), torch.float32, "fp32_tiled"),
                ("hs", (1, k, t, d, v), torch.bfloat16, "tensor_core")]
    for arch in list_archs():
        cfg, smoke = get_config(arch), get_config(arch, smoke=True)
        out += [(arch, (4, 1, 1024, cfg.d_model, cfg.vocab_size),
                 torch.bfloat16, "tensor_core"),
                (arch, (4, 1, 1024, cfg.d_model, cfg.vocab_size),
                 torch.float32, "fp32_tensor_core"),
                (arch + " smoke", (4, 1, 64, smoke.d_model,
                                   smoke.vocab_size), torch.float32,
                 {128: "fp32_tiled", 256: "fp32_tensor_core"}[
                     smoke.d_model])]
    return out


@pytest.mark.parametrize("label,shape,dtype,want", _path_shapes(),
                         ids=lambda x: str(x) if isinstance(x, str) else None)
def test_dispatch_rule_on_every_path_shape(label, shape, dtype, want):
    assert body_for(*shape, dtype) == want


@pytest.mark.parametrize("shape,dtype,want", [
    ((3, 3, 9, 31, 17), torch.bfloat16, "fma"),
    ((3, 1, 3, 33, 1024), torch.bfloat16, "tensor_core"),
    ((2, 2, 8, 32, 16), torch.bfloat16, "tensor_core"),
    ((1, 1, 8, 16, 127), torch.float32, "fma"),
    ((1, 1, 8, 16, 128), torch.float32, "fp32_tiled"),
    ((1, 1, 8, 191, 128), torch.float32, "fp32_tiled"),
    ((1, 1, 8, 192, 128), torch.float32, "fp32_tensor_core"),
    ((1, 1, 8, 192, 127), torch.float32, "fma"),
    ((1, 1, 1, 2048, 32001), torch.float32, "fp32_tensor_core"),
    ((1, 1, 8, 192, 128), torch.bfloat16, "tensor_core"),
    ((1, 1, 8, 36, 255), torch.bfloat16, "fma"),
    ((1, 1, 8, 36, 256), torch.bfloat16, "tensor_core"),
    ((1, 1, 0, 64, 256), torch.bfloat16, "fma"),
    ((1, 1, 8, 0, 256), torch.float32, "fma"),
    ((1, 1, 8, 64, 0), torch.float32, "fma")])
def test_dispatch_rule_at_its_edges(shape, dtype, want):
    assert body_for(*shape, dtype) == want


def test_a_forced_body_is_checked_and_cpu_tensors_run_the_plain_version():
    feats, heads, labels = (torch.from_numpy(x) for x in
                            _f32_case(2, 2, 16, 8, 130))
    before = head_losses.launches
    for body in BODIES:
        assert torch.equal(head_losses(feats, heads, labels, body=body),
                           head_losses_ref(feats, heads, labels))
    assert head_losses.launches == before
    with pytest.raises(ValueError, match="unknown body"):
        head_losses(feats, heads, labels, body="tf32")
