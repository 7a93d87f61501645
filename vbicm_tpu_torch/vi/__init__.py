from .elbo import (
    make_loss_step1,
    make_loss_step2,
    moment_match_loss,
    reparameterize,
    term1,
    term2,
    term3,
    term4,
    term5,
)
from .train import TrainResult, TwoStepTrainer

__all__ = [
    "term1",
    "term2",
    "term3",
    "term4",
    "term5",
    "reparameterize",
    "moment_match_loss",
    "make_loss_step1",
    "make_loss_step2",
    "TwoStepTrainer",
    "TrainResult",
]
