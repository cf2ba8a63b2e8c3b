r"""Training harness (counterpart of ``zuko_tpu/parallel``). The device mesh
and the multi-device layer are not ported yet."""

from .train import TrainState, make_mle_step, make_reverse_kl_step, train_mle

__all__ = ["TrainState", "make_mle_step", "make_reverse_kl_step", "train_mle"]
