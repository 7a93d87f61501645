from .elbo import (
    make_loss_step1,
    make_loss_step1_flow,
    make_loss_step1_fullcov,
    make_loss_step2,
    moment_match_loss,
    reparameterize,
    reparameterize_fullcov,
    term1,
    term1_fullcov,
    term2,
    term3,
    term3_fullcov,
    term4,
    term5,
)
from .refine import refine_posterior
from .train import TrainResult, TwoStepTrainer

__all__ = [
    "term1",
    "term2",
    "term3",
    "term4",
    "term5",
    "reparameterize",
    "reparameterize_fullcov",
    "term1_fullcov",
    "term3_fullcov",
    "moment_match_loss",
    "make_loss_step1",
    "make_loss_step1_flow",
    "make_loss_step1_fullcov",
    "make_loss_step2",
    "refine_posterior",
    "TwoStepTrainer",
    "TrainResult",
]
