"""dl_vqa_tpu_torch — the PyTorch and CUDA port of dl_vqa_tpu.

A second package beside the JAX one, which stays the reference it is held
against. It mirrors that package's layout:

``models``   ModelConfig and the VqaNet module (eval and train forward).
``ops``      Plain PyTorch ops, the loss and metric, and the hand-written
             Hopper kernels beside them (``csrc/*.cu``, built with nvcc on
             first use).
``train``    The train state, the Adam train step and the eval step.
``data``     The question tokenizer and encoder, the image constants.
``utils``    The weight bridge to and from JAX parameters, the npz reader.
``predict``  The Predictor: questions and images in, top-k answers out.

It imports ``torch`` and never ``jax``, and nothing of ``dl_vqa_tpu``:
what it needs from that package's JAX-free modules (tokenizer, question
encoder, image constants, the state-dict mapping) it keeps as its own
copies, each held to its original by a test. Its entry points run on the
GPU unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
