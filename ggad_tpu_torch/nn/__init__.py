from ggad_tpu_torch.nn.layers import DenseNoBias, GCNLayer, MLPHead, PReLU

__all__ = ["DenseNoBias", "GCNLayer", "MLPHead", "PReLU"]
