"""Shared helpers of the port's tests (``tests/test_torch_*.py``).

* ``requires_cuda`` marks a test that needs an NVIDIA card (and ``nvcc``
  to build the port's kernels); such a test takes the ``cuda_device``
  fixture, which decides at run time, never at import, and skips with a
  reason where there is no card. Run them on the card with
  ``PYTHONPATH=src python -m pytest --noconftest -m cuda
  tests/test_torch_*_cuda.py`` (``--noconftest``: the suite's
  ``conftest.py`` imports JAX, which the card's machine need not have).
* :class:`JaxDraws` replays the JAX reference's key schedule as a
  ``draws`` source for ``repro_torch.core.runner.run_experiment`` (or for
  a test that drives ``facade_round`` itself), so the port and the
  reference see the same initial parameters, batches and topologies, for
  the CNNs and the language models, and under network simulation the
  same netsim uniforms and fault draws (``net_uniform``/``net_randint``/
  ``net_normal``: the reference's counter stream) and, under an adaptive
  topology policy, the same participation uniforms and Gumbel noise
  (``policy_draw``/``policy_draw_at``: the reference's keys); its ``state()``/
  ``set_state`` let a checkpointed run resume it. It imports JAX only
  when built.
* :func:`chip_smoke_constant` reads a number that ``chip_smoke.py``
  defines (a tolerance the card's gates share with the tests) from the
  script's text.
"""
from __future__ import annotations

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.interop import lm_params_from_jax, params_from_jax
from repro_torch.models.base import CNNConfig
from repro_torch.tree import tree_map

requires_cuda = pytest.mark.cuda
CHIP_SMOKE = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"


def chip_smoke_constant(name: str) -> float:
    """``chip_smoke.<name>``, a number or a power of 2, read from the
    script's text (importing the script takes seconds)."""
    text = re.search(rf"^{name} = (.+)$", CHIP_SMOKE.read_text(),
                     re.M).group(1)
    power = re.fullmatch(r"2\.0 \*\* (-?\d+)", text)
    return 2.0 ** int(power.group(1)) if power else float(text)


@pytest.fixture
def cuda_device():
    """The card, or a skip with the reason."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False here")
    from repro_torch.kernels import build
    try:
        build.nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    return torch.device("cuda")


def ref_cfg(cfg):
    """The reference config (``CNNConfig`` or ``ModelConfig``) with the
    same fields as the port's."""
    from repro.models import base
    from repro_torch.models.base import CNNConfig
    cls = base.CNNConfig if isinstance(cfg, CNNConfig) else base.ModelConfig
    return cls(**dataclasses.asdict(cfg))


def perms_from_key(key, n: int, r: int):
    """The permutations ``repro.core.topology.random_regular(key, n, r)``
    draws, in the order the port's ``random_regular`` reads them."""
    import jax
    n_cycles = max(1, r // 2)
    keys = jax.random.split(key, n_cycles + 1)
    perms = [jax.random.permutation(keys[i], n) for i in range(n_cycles)]
    if r % 2 == 1:
        perms.append(jax.random.permutation(keys[-1], n))
    return torch.from_numpy(np.stack([np.array(p) for p in perms])).long()


class JaxDraws:
    """The reference runner's draws for ``seed`` (its ``engine=False``
    loop): ``k_init, k_data = split(PRNGKey(seed))``; the state init
    splits ``k_init``; each round splits ``k_data`` for the batch indices
    and the state's key for the topology."""

    def __init__(self, seed: int):
        import jax
        self._jax = jax
        self._k_init, self._k_data = jax.random.split(
            jax.random.PRNGKey(seed))
        self._rng = None

    def facade_init(self, binding, k: int, head_jitter: float):
        from repro.core.bindings import make_binding
        from repro.core.state import init_facade_state
        st = init_facade_state(make_binding(ref_cfg(binding.cfg)),
                               self._k_init, 1, k, head_jitter=head_jitter)
        self._rng = st.rng
        lm = not isinstance(binding.cfg, CNNConfig)
        heads_k = _node0(st.heads, lead=1, lm=lm)
        return {**_node0(st.cores, lm=lm),
                **tree_map(lambda l: l[0], heads_k)}, heads_k

    def baseline_init(self, binding):
        from repro.core.bindings import make_binding
        from repro.core.state import init_baseline_state
        st = init_baseline_state(make_binding(ref_cfg(binding.cfg)),
                                 self._k_init, 1)
        self._rng = st.rng
        return _node0(st.params)

    def batch_indices(self, n: int, h: int, b: int, per_node: int):
        self._k_data, k_b = self._jax.random.split(self._k_data)
        idx = self._jax.random.randint(k_b, (n, h, b), 0, per_node)
        return torch.from_numpy(np.array(idx)).long()

    def perms(self, n: int, r: int):
        self._rng, sub = self._jax.random.split(self._rng)
        return perms_from_key(sub, n, r)

    def gumbel(self, n: int):
        """DAC's round draw: ``key, k_top = split(state.rng)``, then
        ``jax.random.gumbel(k_top, (n, n))``."""
        self._rng, sub = self._jax.random.split(self._rng)
        return torch.from_numpy(np.array(self._jax.random.gumbel(sub,
                                                                 (n, n))))

    def _policy_draw(self, key, n: int):
        """``repro.topo.gumbel_graph``'s draws from ``key``: ``k_part, k_gum
        = split(key)``, then ``uniform(k_part, (n,))`` and ``gumbel(k_gum,
        (n, n))``."""
        from repro_torch.topo import TopoDraw
        jax = self._jax
        k_part, k_gum = jax.random.split(key)
        return TopoDraw(
            torch.from_numpy(np.array(jax.random.uniform(k_part, (n,)))),
            torch.from_numpy(np.array(jax.random.gumbel(k_gum, (n, n)))))

    def policy_draw(self, n: int):
        """An adaptive policy's round draw for FACADE, EL and DAC, from
        the key the round splits off the state's: ``key, sub =
        split(state.rng)``, then :meth:`_policy_draw` of ``sub``."""
        self._rng, sub = self._jax.random.split(self._rng)
        return self._policy_draw(sub, n)

    def policy_draw_at(self, seed: int, tag, rnd: int, n: int):
        """The ring baselines' round draw, ``repro.topo.static_key``:
        ``fold_in(fold_in(PRNGKey(seed), tag), rnd)`` (no ``tag`` fold
        when it is ``None``: ``repro.topo.inclusion_stats``'s round key),
        then :meth:`_policy_draw`."""
        jax = self._jax
        key = jax.random.PRNGKey(seed)
        if tag is not None:
            key = jax.random.fold_in(key, tag)
        return self._policy_draw(jax.random.fold_in(key, rnd), n)

    def _net_key(self, seed: int, tag: int, index: int):
        """``repro.netsim``'s counter stream, ``fold_in(fold_in(PRNGKey(
        seed), tag), index)``."""
        jax = self._jax
        return jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed), tag), index)

    def net_uniform(self, seed: int, tag: int, index: int, shape):
        return torch.from_numpy(np.array(self._jax.random.uniform(
            self._net_key(seed, tag, index), tuple(shape))))

    def net_randint(self, seed: int, tag: int, index: int, shape,
                    high: int):
        return torch.from_numpy(np.array(self._jax.random.randint(
            self._net_key(seed, tag, index), tuple(shape), 0,
            high))).long()

    def net_normal(self, seed: int, tag: int, index: int, leaf: int,
                   shape):
        """``repro.resil``'s payload noise: ``normal(fold_in(stream,
        leaf), shape)`` on the stream of ``(seed, tag, index)``."""
        jax = self._jax
        key = jax.random.fold_in(self._net_key(seed, tag, index), leaf)
        return torch.from_numpy(np.array(jax.random.normal(
            key, tuple(shape), jax.numpy.float32)))

    def state(self) -> dict:
        """Where the key schedule stands: the data key and the state's
        key, as numpy ``uint32`` arrays (what a checkpoint saves)."""
        return {"k_data": np.asarray(self._k_data),
                "rng": np.asarray(self._rng)}

    def set_state(self, state: dict):
        """Restore :meth:`state`'s keys (numpy arrays or CPU tensors)."""
        jnp = self._jax.numpy
        self._k_data, self._rng = (
            jnp.asarray(np.asarray(state[k]), dtype=jnp.uint32)
            for k in ("k_data", "rng"))


def _node0(tree, lead: int = 0, lm: bool = False):
    """Node 0 of a node-stacked reference tree, converted to the port (a
    language model's leaves cross as they are)."""
    node0 = tree_map(lambda l: np.asarray(l)[0], tree)
    return lm_params_from_jax(node0) if lm else params_from_jax(node0,
                                                                lead=lead)
