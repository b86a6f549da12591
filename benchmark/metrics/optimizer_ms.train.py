"""Host milliseconds of the update a train step (the program's two spans
``train.update``: every gradient divided by N, then SGD, the schedule
and the ``OBJ_Target`` renorm): the host's wall time inside them, the
mean over the traced stretch's steps (``forward_ms.train`` says why host
time)."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "train", "train.update", "train.step",
                                 device=False)
