from hpvpinns_tpu_torch.training.ensemble import EnsembleResult, train_ensemble
from hpvpinns_tpu_torch.training.gauss_newton import GNResult, gauss_newton
from hpvpinns_tpu_torch.training.timemarch import TimeMarchResult, time_march
from hpvpinns_tpu_torch.training.trainer import TrainResult, make_optimizer, train

__all__ = ["EnsembleResult", "GNResult", "TimeMarchResult", "TrainResult", "gauss_newton", "make_optimizer",
           "time_march", "train", "train_ensemble"]
