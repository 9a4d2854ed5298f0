"""The benchmark's plain reference of VISinger: a frozen float32 copy of the
model, the discriminators, the STFT and mel, the losses and the two AdamW
updates in plain PyTorch, with relative attention and the WaveNet stack
written out (``rel_attention.py``, ``wavenet_stack.py``) instead of kernels.

It imports nothing of the program under test and takes nothing the program
made: the benchmark hands both sides the same seed-made weights and inputs.
Importing it turns TF32 off, so float32 products are float32."""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
