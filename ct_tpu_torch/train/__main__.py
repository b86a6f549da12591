"""``python -m ct_tpu_torch.train``: the training CLI (``train/cli.py``)."""

if __name__ == "__main__":
    from ct_tpu_torch.train.cli import main

    main()
