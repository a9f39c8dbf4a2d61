from .train_step import (TrainState, init_state, lm_loss, make_train_step,
                         value_and_grad)
from .trainer import Trainer, TrainerCfg
