from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.models.resnet import get_resnet, get_resnet_v1, get_resnet_v2
from mpi4dl_tpu_torch.models.seqblock import SeqBlock, make_seq_cp_train_step

__all__ = ["SeqBlock", "amoebanetd", "build_model", "get_resnet", "get_resnet_v1",
           "get_resnet_v2", "make_seq_cp_train_step"]


def build_model(cfg, device="cuda", seed=None):
    """Build the model named by ``cfg.model`` at cfg's geometry, parameters
    in ``cfg.param_dtype`` (seed: ``cfg.seed`` unless given).  For resnet,
    ``cfg.num_layers`` is the block count n of the v2 depth 9n+2 (n = 12 is
    ResNet-110 v2), as in the JAX package."""
    from mpi4dl_tpu_torch.utils.misc import get_depth

    in_shape = (cfg.batch_size // cfg.parts, cfg.image_size, cfg.image_size, 3)
    seed = cfg.seed if seed is None else seed
    if cfg.model == "amoebanet":
        return amoebanetd(
            in_shape, num_classes=cfg.num_classes, num_layers=cfg.num_layers,
            num_filters=cfg.num_filters, device=device, seed=seed,
            dtype=cfg.param_dtype,
        )
    if cfg.model == "resnet":
        return get_resnet(
            in_shape, depth=get_depth(2, cfg.num_layers),
            num_classes=cfg.num_classes, version=2,
            softmax_in_model=cfg.softmax_in_model, device=device, seed=seed,
            dtype=cfg.param_dtype,
        )
    raise ValueError(f"unknown model {cfg.model!r}")
