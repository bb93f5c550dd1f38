"""PyTorch + CUDA port of the ScaNeRF multi-tile renderer for NVIDIA Hopper.

A package beside the JAX reference ``scanerf_tpu``: module paths mirror
it (``scanerf_tpu_torch/render/renderer.py`` pairs with
``scanerf_tpu/render/renderer.py``), and it imports nothing from it.

Entry points (``render.renderer.load_scene``, ``render_rays``,
``render_image``) take an explicit ``device`` and default to ``"cuda"``;
without CUDA they raise. ``device="cpu"`` runs the plain PyTorch version
of every kernel. The three hand-written CUDA kernels live in ``csrc/``
and are built with ``nvcc`` on first use (``_build.py``).
"""
