from ggad_tpu_torch.models.ggad import GGAD, GGADOutput

__all__ = ["GGAD", "GGADOutput"]
