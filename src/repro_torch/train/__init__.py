from repro_torch.train.step import (  # noqa: F401
    TrainConfig, loss_and_grads, make_train_step, value_and_grad)
