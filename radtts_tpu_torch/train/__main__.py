"""python -m radtts_tpu_torch.train: the RADTTS training CLI
(train/cli.py)."""

from radtts_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
