"""DSP ops on tensors.  Each op accepts leading batch/time dimensions and
works on the trailing axis, so one code path serves a single streaming
frame and a whole utterance.

Re-exports the names of the JAX package's percepnet_tpu.ops."""

from percepnet_tpu_torch.ops.dft import forward_dft, inverse_dft  # noqa: F401
from percepnet_tpu_torch.ops.bands import (  # noqa: F401
    band_energy, band_corr, interp_band_gain)
from percepnet_tpu_torch.ops.window import apply_window  # noqa: F401
from percepnet_tpu_torch.ops.activations import (  # noqa: F401
    tansig_approx, sigmoid_approx)
from percepnet_tpu_torch.ops.postfilter import post_filter  # noqa: F401
from percepnet_tpu_torch.ops.comb import comb_filter_windows  # noqa: F401
from percepnet_tpu_torch.ops.pitch import (  # noqa: F401
    pitch_downsample, pitch_search, pitch_track)
