"""PyTorch/CUDA port of the xllm-service engine tier.

A second package beside `xllm_service_tpu` (the JAX reference, which it
never imports). Module paths mirror the JAX package. Entry points run on
`cuda` unless the caller passes `device="cpu"`; on CUDA tensors the
attention dispatchers launch the hand-written kernels under `csrc/`, on CPU
tensors their plain PyTorch versions.
"""
