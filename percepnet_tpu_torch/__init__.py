"""percepnet_tpu_torch: the PyTorch/CUDA port of percepnet_tpu.

Module names mirror the JAX package (`percepnet_tpu`), which stays the
reference the port is held against.  The port imports torch, numpy, the
standard library and, for STOI's resampling (utils.metrics), scipy.

Entry points (`pipeline.enhance_chunk`, `pipeline.enhance_utterance`,
`serve.StreamingServer`) run on the CUDA card unless the caller passes
device="cpu"; with no card they raise instead of running on the host.

TF32 is switched off for matmuls and cuDNN convolutions here, at import:
the parity gates (1e-4 PCM, exact pitch periods) do not survive its
10-bit mantissa, and cuDNN enables it by default.  So is cuBLAS's
reduction of split-K partial sums in bf16: the bf16 serving tier
accumulates in f32, as the JAX package's does.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
