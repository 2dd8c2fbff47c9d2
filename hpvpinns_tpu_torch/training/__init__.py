from hpvpinns_tpu_torch.training.trainer import TrainResult, make_optimizer, train

__all__ = ["TrainResult", "make_optimizer", "train"]
