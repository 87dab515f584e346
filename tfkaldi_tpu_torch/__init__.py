"""tfkaldi_tpu_torch: the PyTorch/CUDA port of :mod:`tfkaldi_tpu`.

The port runs the hybrid recipe of ``config/config_AURORA4.cfg`` on an
NVIDIA H100: wav → 40-dim log-fbank → per-speaker CMVN → ±5-frame splice →
the 440→6×2048→2000 relu+batchnorm DNN, trained with the reference's
optimizer, rollback and checkpoint semantics, then softmax ÷ prior → Kaldi
ark of log pseudo-likelihoods, decoded by Kaldi's ``latgen-faster-mapped``
to a WER; the Kaldi GMM steps that give the alignments run from the same
CLI (:mod:`tfkaldi_tpu_torch.kaldi`). ``model = tdnn`` or ``cnn`` trains
and decodes the TDNN and CNN families on that pipeline, with no hand
kernel on their paths. ``model = lstm`` or ``gru`` in ``[nnet]``
trains and decodes the repo's recurrent network (2 x 512 bidirectional,
config_AURORA4_ctc.cfg) on the same pipeline under frame cross-entropy,
and ``loss = ctc`` the character-CTC recipe. ``model = seq2seq`` with
``loss = attention`` runs the joint CTC-attention conformer recipe
(config_AURORA4_attention.cfg) with its attention-rescoring text decode,
in plain PyTorch: no hand kernel lies on that path.
The seven device kernels of these paths (the preemphasis/framing pass, the
fused FFN block of the DNN's eval forward, the fused BN backward of its
hidden layers, and the forward and backward steps of the LSTM and GRU
recurrences) are hand-written CUDA for ``sm_90a`` under ``ops/csrc/``, each
with a plain PyTorch version beside it that defines its numerics and runs
on CPU tensors.

The package imports ``torch`` and never ``jax``, and nothing of the JAX
package: every host module it needs is its own copy (the Kaldi I/O of
:mod:`tfkaldi_tpu_torch.io` included).
"""

__version__ = "0.1.0"
