"""karpenter_core_tpu_torch — the provisioning solve in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100.

A port of ``karpenter_core_tpu`` (the JAX package beside it, which stays the
reference every module here is held against).  The port imports torch and
numpy only — never JAX, and never a module of the JAX package: host-side
modules it needs are copied in under the same layout.

Layer map:
  - ``apis``/``scheduling``/``utils`` — API types and the host constraint
                          algebra (copies).
  - ``cloudprovider``   — provider SPI and the fake catalog (copies).
  - ``models``          — snapshot encoding and pod ingestion (copies).
  - ``ops``             — the solve in torch: mask algebra and the class scan.
  - ``kernels``         — the hand-written CUDA kernels, each with its plain
                          torch twin (``csrc/`` holds the sources).
  - ``solver``          — ``CudaSolver``: encode, prepare, solve, decode.
  - ``carry``           — maps the reference package's numpy kernel inputs to
                          the port's tensors.

Entry points take ``device=None``, which means CUDA; the CPU is used only
when the caller passes ``device="cpu"``.
"""
