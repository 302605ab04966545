"""Ops: the updaters (``updater_ops``), the 2-D convolution and pools
(``conv_ops``) and the dropout / batch-norm / LRN ops (``nn_ops``) of
the ported layers."""
