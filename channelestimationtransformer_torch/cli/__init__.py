"""Command-line drivers of the port (the counterparts of ``experiments/``):
``python -m channelestimationtransformer_torch.cli.train_informer`` and
``python -m channelestimationtransformer_torch.cli.generate_dataset``."""
