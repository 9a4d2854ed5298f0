"""VISinger synthesis in PyTorch with hand-written CUDA kernels for the
NVIDIA H100 (sm_90a): the port of the JAX package ``visinger_tpu``, which
stays the reference.  Imports torch and numpy only."""
