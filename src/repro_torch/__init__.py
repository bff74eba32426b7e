"""Parallel Space Saving in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch counterpart of the JAX package ``repro``: the same modules under
the same names (``core``, ``kernels``, ``engine``, ``service``, ``eval``,
``plan``),
held bit for bit against it by the ``tests/test_torch_*.py`` files. Every
function takes leading batch dimensions written out where JAX used ``vmap``.

Importing the package needs neither a GPU nor ``nvcc``: the CUDA kernels in
``csrc/`` are compiled at their first launch on a CUDA tensor
(``kernels/build.py``). Entry points run on the card unless the caller asks
for the CPU (``EngineConfig(device="cpu")``, ``--device cpu``); on the CPU
every kernel wrapper computes its plain PyTorch version. Every ``"auto"``
resolves through the plan of its device (``plan``), which
``python -m repro_torch.launch.tune`` measures.
"""
