"""tpuasr_torch: the PyTorch + CUDA port of tpuasr's batched decode path.

The serving slice runs on one NVIDIA H100:

    8 kHz wav batch -> FusedFeaturizer (CUDA fbank kernel)
      -> DeepSpeechCTC: conv1+BN, conv2+BN, 4 x BiGRU with masked BN
         (CUDA GRU scan kernel, int8 or bf16) -> head + log-softmax
      -> CTC prefix beam search (CUDA beam kernel) -> tokens

The JAX package ``tpuasr`` stays the reference: every public function here
keeps its layouts, so tests feed the same inputs through both. This package
imports torch and never jax.

Every kernel wrapper runs its plain PyTorch version for a CPU tensor and
launches its CUDA kernel (built at first use by ``tpuasr_torch._build``) for
a CUDA tensor; it never falls back from one to the other.
"""
