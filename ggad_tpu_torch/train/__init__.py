"""The trainers (full-batch and minibatch), their losses, checkpoints
and configs."""
