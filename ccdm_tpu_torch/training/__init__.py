"""The trainer, its vicinity batches, hyperparameters and state, the aux
regressor's training, and the optimizer plumbing it shares with the ILI
embedding's."""
