"""Training: the RADTTS trainer and its CLI (`python -m
radtts_tpu_torch.train`, train/cli.py), the vocoder trainer, optimizers and
checkpoints."""


def main(argv=None):
    """The RADTTS training CLI (train/cli.py:main)."""
    from radtts_tpu_torch.train.cli import main as cli_main
    return cli_main(argv)
