from repro_torch.training.optim import (
    AdamWConfig,
    adafactor_init,
    adafactor_update,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
from repro_torch.training.ramp_training import train_ramps
from repro_torch.training.train_loop import (
    TrainConfig,
    init_state,
    make_train_step,
    ramp_mask,
    train,
)
