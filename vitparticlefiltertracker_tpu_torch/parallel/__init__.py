from vitparticlefiltertracker_tpu_torch.parallel.mesh import Mesh, bank_slice, make_mesh, vit_param_shard

__all__ = ["Mesh", "make_mesh", "bank_slice", "vit_param_shard"]
