"""The PercepNet gain/strength network as an nn.Module.

Re-exports the names of the JAX package's percepnet_tpu.models, with
three renamed: the module `PercepNet` holds the parameters that
`PercepNetParams` holds there and draws the initialization that
`init_params(key)` draws (from a torch.Generator), and the whole-sequence
`forward(params, ...)` is its method `PercepNet.forward`."""

from percepnet_tpu_torch.models.percepnet import (  # noqa: F401
    PercepNet, forward_stream, init_model_state, param_count)
