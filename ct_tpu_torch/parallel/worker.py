"""``python -m ct_tpu_torch.parallel.worker SPEC RANK``: one rank of
``parallel.distributed.launch``."""

import sys

if __name__ == "__main__":
    from ct_tpu_torch.parallel.distributed import run_worker

    run_worker(sys.argv[1], int(sys.argv[2]))
