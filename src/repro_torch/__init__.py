"""PyTorch/CUDA port of the FlashBias system (the JAX package ``repro`` is
its reference).

Layout mirrors ``repro``: ``configs``, ``core`` (bias math, attention),
``kernels`` (hand-written Hopper CUDA kernels beside their plain PyTorch
versions, dispatched by ``kernels.ops``), ``models`` (the dense ALiBi LM),
``serve`` (continuous-batching engine) and ``launch``. Entry points run on
the CUDA device unless the caller passes ``device="cpu"``.
"""
