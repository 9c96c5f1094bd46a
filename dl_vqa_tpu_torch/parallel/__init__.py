"""The mesh axes 'data', 'seq', 'expert', 'model' and 'stage', ZeRO stages
1 and 3, and the multi-process tier
(``dl_vqa_tpu_torch.parallel.multihost``) on ``torch.distributed``: the
port's counterpart of ``dl_vqa_tpu.parallel``.
:mod:`~dl_vqa_tpu_torch.parallel.tensor` holds the tensor- and
expert-parallel collectives and the cutting of a state into shards,
:mod:`~dl_vqa_tpu_torch.parallel.sequence` the 'seq' axis's token split,
:mod:`~dl_vqa_tpu_torch.parallel.pipeline` the 'stage' axis's GPipe
schedule, :mod:`~dl_vqa_tpu_torch.parallel.zero` the 'data' wrappers."""

from dl_vqa_tpu_torch.parallel import multihost
from dl_vqa_tpu_torch.parallel.mesh import Mesh, make_mesh
from dl_vqa_tpu_torch.parallel.pipeline import PipelineContext
from dl_vqa_tpu_torch.parallel.sequence import SequenceContext

__all__ = ["make_mesh", "Mesh", "multihost", "SequenceContext",
           "PipelineContext"]
