from hpvpinns_tpu_torch.training.gauss_newton import GNResult, gauss_newton
from hpvpinns_tpu_torch.training.trainer import TrainResult, make_optimizer, train

__all__ = ["GNResult", "TrainResult", "gauss_newton", "make_optimizer", "train"]
