"""The 'data' mesh axis, ZeRO stages 1 and 3, and the multi-process tier
(``dl_vqa_tpu_torch.parallel.multihost``) on ``torch.distributed``: the
port's counterpart of ``dl_vqa_tpu.parallel``. The other axes (tensor,
expert, sequence, pipeline) are ROADMAP queue 1, item 9."""

from dl_vqa_tpu_torch.parallel import multihost
from dl_vqa_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = ["make_mesh", "Mesh", "multihost"]
