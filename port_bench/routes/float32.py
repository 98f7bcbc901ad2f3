"""The float32 band's route: the model's own ``forward`` over the block
band a call (``banded_spmm``: one batched product a diagonal, summed into
the output)."""

QUANTIZED = False


def prepare(model, band):
    return lambda x: model(band, x)
