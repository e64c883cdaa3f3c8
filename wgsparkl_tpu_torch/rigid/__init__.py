from wgsparkl_tpu_torch.rigid.body import BodyCoupling, RigidWorld

__all__ = ["RigidWorld", "BodyCoupling"]
