"""idiaptts_torch — the PyTorch/CUDA port of idiaptts_tpu.

Text -> waveform synthesis, training, evaluation and vocoding run here
on an NVIDIA Hopper GPU, with every Pallas kernel of the JAX package
replaced by a hand-written CUDA kernel (``csrc/``).  The JAX package
``idiaptts_tpu`` stays the reference the port is tested against; the
port imports nothing of it and keeps its own copies of its JAX-free
modules.

Layer map (mirrors idiaptts_tpu):
  ops/       — kernel dispatch, MLPG, BiLSTM and WaveNet kernels, mcep,
               WORLD vocoder
  models/    — rnn_dyn and WaveNet models, named-dict wrapper, weight
               converter
  data/      — readers, datasets, normalisation, question and duration
               label generation (with the native question matcher)
  train/     — model handler (one device or data-parallel), trainers
  synth/     — the fused label -> waveform pipeline (one device, or a
               batch split over several), the servers, the built-in
               text front end and TTSModel (text -> wav)
  parallel/  — data parallelism over torch.distributed
  utils/     — figures, equality helpers, misc host helpers
  egs/       — the LJSpeech and intonation recipes
  assets/    — the lexicon and question files
"""
