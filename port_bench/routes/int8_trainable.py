"""The int8 band's training route (GCN): ``prepare_quant_trainable`` once
(normalized, quantized per tile, laid out feature-major as the forward
operand and, transposed, as the backward one), then
``apply_quant_trainable`` a step: K4 forward and K4 over the transposed
band backward."""

QUANTIZED = True


def prepare(model, band):
    q, qT, dinv = model.prepare_quant_trainable(band)
    return lambda x: model.apply_quant_trainable(q, qT, dinv, x)
