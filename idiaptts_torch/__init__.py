"""idiaptts_torch — the PyTorch/CUDA port of idiaptts_tpu.

The label -> waveform serving path runs here on an NVIDIA Hopper GPU,
with every Pallas kernel of that path replaced by a hand-written CUDA
kernel (``csrc/``).  The JAX package ``idiaptts_tpu`` stays the
reference the port is tested against; its JAX-free modules (question
features, normalisation, the synthesis server, model configs) are
reused by import.

Layer map (mirrors idiaptts_tpu):
  ops/       — kernel dispatch, MLPG, BiLSTM kernels, mcep, WORLD vocoder
  models/    — rnn_dyn acoustic model, named-dict wrapper, weight converter
  synth/     — the fused label -> waveform pipeline
"""
