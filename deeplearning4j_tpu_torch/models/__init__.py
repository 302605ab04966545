"""Models: the decoder-only causal LM and BERT (masked-LM training and
the QA head)."""
