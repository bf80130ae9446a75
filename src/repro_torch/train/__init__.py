from repro_torch.train.step import TrainConfig, loss_and_grads, make_train_step  # noqa: F401
