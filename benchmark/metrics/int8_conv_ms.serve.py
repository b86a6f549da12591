"""Device milliseconds of the int8 convs a request (the program's spans
``model.int8_conv``, one a quantized conv: the activation's quantization,
im2col and the int8 GEMM, the rescale), summed over the request's convs:
stream time between CUDA events at each one's start and end, any idle of
the device inside them included, the mean over the traced stretch's
requests."""

from benchmark.harness import program_spans

program_spans.listen()


def read(run):
    return program_spans.mean_ms(run, "serve", "model.int8_conv", "eval.step",
                                 device=True)
