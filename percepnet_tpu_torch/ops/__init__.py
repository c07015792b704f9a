"""DSP ops on tensors.  Each op accepts leading batch/time dimensions and
works on the trailing axis, so one code path serves a single streaming
frame and a whole utterance."""
