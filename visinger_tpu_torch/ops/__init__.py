"""The port's ops.  Importing the package registers kernels K1, K3 and K2
as ``torch.library`` ops (``visinger_torch::rel_attention_fwd``,
``::rel_attention_bwd``, ``::wavenet_stack``): an exported program needs
them before ``torch.export.load``."""

from visinger_tpu_torch.ops import rel_attention, wavenet_stack  # noqa: F401
