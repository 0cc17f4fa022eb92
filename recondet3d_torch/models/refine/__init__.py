from recondet3d_torch.models.refine.bev_unet import BEVHeightOccupancy
from recondet3d_torch.models.refine.refinement import SparseRefinement, batch_voxelize
from recondet3d_torch.models.refine.sparse_encoder import MaskedBatchNorm, SparseEncoder
from recondet3d_torch.models.refine.vfe import hard_simple_vfe
