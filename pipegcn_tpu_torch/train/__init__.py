from .losses import cross_entropy_sum
from .metrics import accuracy, calc_acc, micro_f1
from .optim import adam_init, adam_update

__all__ = ["cross_entropy_sum", "accuracy", "calc_acc", "micro_f1",
           "adam_init", "adam_update"]
