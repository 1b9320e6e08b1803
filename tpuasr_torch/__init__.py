"""tpuasr_torch: the PyTorch + CUDA port of tpuasr, in progress.

These slices run on one NVIDIA H100. Serving (``serve.Recognizer``):

    8 kHz wav batch -> FusedFeaturizer (CUDA fbank kernel)
      -> DeepSpeechCTC: conv1+BN, conv2+BN, 4 x BiGRU with masked BN
         (CUDA GRU scan kernel, int8 or bf16) -> head + log-softmax
      -> CTC prefix beam search (CUDA beam kernel) -> tokens

CapsNet (BASELINE config 4), served through the same ``Recognizer``:

    wav batch -> FusedFeaturizer -> CapsNetCTC: stem conv + BN, primary
      capsules, squash -> dynamic routing (CUDA kernel K8, u_hat never
      stored) -> capsule lengths -> log-softmax -> greedy or beam

ResNet-CTC (BASELINE config 2), served the same way and trained:

    wav batch -> FusedFeaturizer -> ResNetCTC: stem conv + BN, 4 stages
      of residual 3x3 conv blocks (cuDNN, float32) -> head ->
      log-softmax -> greedy or beam

The featurizer takes fbank, MFCC or spectrogram features with kaldi or
torch framing, ``center``, splicing and dither (BASELINE config 1).

Training (``train.Trainer.train_step``), in float32:

    wav batch -> Featurizer -> DeepSpeechCTC in training mode (batch
      statistics, dropout; CUDA GRU scan and BPTT kernels) -> CTC loss
      (CUDA alpha/beta kernels) -> global-norm clip -> AdamW

The JAX package ``tpuasr`` stays the reference: every public function here
keeps its layouts, so tests feed the same inputs through both. This package
imports torch, and never jax nor any module of ``tpuasr``.

Every kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches its CUDA kernel (built at first use by ``tpuasr_torch._build``) for
a CUDA tensor; it never falls back from one to the other.
"""
