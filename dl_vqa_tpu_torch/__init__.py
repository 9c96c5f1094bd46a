"""dl_vqa_tpu_torch — the PyTorch and CUDA port of dl_vqa_tpu.

A second package beside the JAX one, which stays the reference it is held
against. It mirrors that package's layout:

``models``   ModelConfig and the VqaNet module (eval forward).
``ops``      Plain PyTorch ops and the hand-written Hopper kernels beside
             them (``csrc/*.cu``, built with nvcc on first use).
``utils``    The weight bridge from JAX parameters and the npz reader.
``predict``  The Predictor: questions and images in, top-k answers out.

It imports ``torch`` and never ``jax``; it shares the JAX-free modules of
``dl_vqa_tpu`` (tokenizer, question encoder, image constants, the
state-dict mapping) rather than copying them.
"""

__version__ = "0.1.0"
