"""python -m radtts_tpu_torch.data: the dataset preflight
(data/preflight.py)."""

from radtts_tpu_torch.data.preflight import main

if __name__ == "__main__":
    main()
