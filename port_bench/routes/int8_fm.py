"""The int8 band's serving route: ``prepare_quantized`` once (the band
quantized per tile and laid out feature-major), then ``apply_quantized`` a
request: K4 over activations kept feature-major across layers."""

import torch

QUANTIZED = True


def prepare(model, band):
    with torch.no_grad():
        adj_q, aux = model.prepare_quantized(band)
    return lambda x: model.apply_quantized(adj_q, aux, x)
