from mpi4dl_tpu_torch.models.amoebanet import amoebanetd
from mpi4dl_tpu_torch.models.seqblock import SeqBlock, make_seq_cp_train_step

__all__ = ["SeqBlock", "amoebanetd", "build_model", "make_seq_cp_train_step"]


def build_model(cfg, device="cuda", seed=None):
    """Build the model named by ``cfg.model`` at cfg's geometry, parameters
    in ``cfg.param_dtype`` (seed: ``cfg.seed`` unless given)."""
    in_shape = (cfg.batch_size // cfg.parts, cfg.image_size, cfg.image_size, 3)
    if cfg.model == "amoebanet":
        return amoebanetd(
            in_shape, num_classes=cfg.num_classes, num_layers=cfg.num_layers,
            num_filters=cfg.num_filters, device=device,
            seed=cfg.seed if seed is None else seed, dtype=cfg.param_dtype,
        )
    if cfg.model == "resnet":
        raise NotImplementedError(
            "ResNet v1/v2 are the next slice of the port (ROADMAP A3)"
        )
    raise ValueError(f"unknown model {cfg.model!r}")
