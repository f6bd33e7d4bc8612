"""tacotronv2_wavernn_chinese_tpu_torch: the Tacotron-2 + WaveRNN Chinese TTS
system in PyTorch, with hand-written CUDA kernels for the two
autoregressive loops (``ops/``) on NVIDIA Hopper.

It imports torch, numpy, scipy and the standard library only.  Weights use
the same nested-dict layout (``[in, out]`` dense kernels) and the same flat
npz format as the JAX package, so one export artifact serves both.

TF32 is switched off here, at import, for every matmul and cuDNN
convolution the port runs outside its kernels: the port holds f32 weights
and its parity tolerances assume full f32 arithmetic.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
