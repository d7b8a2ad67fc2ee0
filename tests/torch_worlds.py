"""Spawning a gloo world and, beside it, the reference in a subprocess,
for the port's LM mesh tests (``tests/test_torch_lm_mesh.py``,
``tests/test_torch_lm_mesh_families.py``, ``tests/test_torch_facade_pod.py``).

Each rank is ``python WORLD_SCRIPT RANK WORLD STORE OUT *ARGS`` and
joins through the file store ``STORE`` (no TCP port); its results land in
``OUT.RANK``. The reference runs as ``python -c SCRIPT IN OUT *ARGS`` with
four forced host devices (the script sets ``XLA_FLAGS`` itself); a world
waits for what it hands over (:func:`wait_for`)."""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
WORLD = 4
JOIN_S = 180


def join(procs, deadline):
    """Wait for ``procs``; a process that fails or outlives ``deadline``
    fails the test (its stderr in the message)."""
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            err = f"timed out after {JOIN_S} s\n{err}"
        errs.append(err if p.returncode else "")
    assert not any(errs), "\n".join(e[-3000:] for e in errs if e)


def start_reference(script: str, ref_in: Path, ref_out: Path, *args):
    """The reference's run of ``script`` on ``ref_in`` started: (its
    process, its deadline)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", script, str(ref_in), str(ref_out),
         *map(str, args)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    return proc, time.monotonic() + JOIN_S


def wait_for(path, timeout_s: float = JOIN_S):
    """Unpickle ``path`` once it exists (written whole by a rename), or
    raise after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} not written in {timeout_s} s")
        time.sleep(0.1)
    with open(path, "rb") as f:
        return pickle.load(f)


def stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def run_world(script: str, tmp: Path, *args) -> list:
    """Each rank's unpickled results of ``tests/<script>`` run as a world
    of :data:`WORLD` ranks."""
    out = str(tmp / "out")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests")]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / script), str(rank),
         str(WORLD), str(tmp / "store"), out, *map(str, args)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for rank in range(WORLD)]
    join(procs, time.monotonic() + JOIN_S)
    results = []
    for r in range(WORLD):
        with open(f"{out}.{r}", "rb") as f:
            results.append(pickle.load(f))
    return results


def near(got, want, tol, msg):
    """``got`` within ``tol`` of ``want``'s largest magnitude (integer
    arrays equal)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{msg}: {got.shape} != {want.shape}"
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, msg)
        return
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    err = float(np.abs(got.astype(np.float64) - want).max()) \
        if want.size else 0.0
    assert err <= tol * scale, f"{msg}: {err} > {tol} x {scale}"
