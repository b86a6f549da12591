"""Device milliseconds of the model's forward a request (the program's
span ``eval.forward`` around ``net(images)``): stream time between CUDA
events at its start and end, any idle of the device inside it included,
the mean over the traced stretch's requests. The program's own twin of
``forward_ms.serve``."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "serve", "eval.forward", "eval.step",
                                 device=True)
