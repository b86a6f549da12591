"""Host milliseconds of matching and the loss a train step (the program's
spans ``train.loss``: ``match_batch``, ``loss_mask``,
``masked_loss_sums``, one a micro-batch), summed over the step's
micro-batches: the host's wall time inside them, the mean over the
traced stretch's steps (``forward_ms.train`` says why host time)."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "train", "train.loss", "train.step",
                                 device=False)
