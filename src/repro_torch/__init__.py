"""repro_torch — the PyTorch/CUDA port of the FACADE reproduction.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy, never ``jax`` and nothing of ``repro``. Public functions keep
the reference's layouts (NHWC images, nested param dicts with the same
keys, node-stacked ``[n, ...]`` state) so the two can be compared like with
like; conv kernels are stored OIHW (``interop`` converts). Step 2c of a
FACADE round (head selection) runs through a hand-written CUDA kernel
(``kernels/head_select``, source in ``csrc/``).

Entry points (``core.runner.run_experiment``, ``core.state`` inits,
``data.pipeline.place``) run on ``device="cuda"`` unless the caller asks
for ``device="cpu"``; they raise when CUDA is absent rather than move to
the CPU on their own.
"""
