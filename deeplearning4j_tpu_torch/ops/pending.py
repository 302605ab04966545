"""The op families not ported yet, by the JAX package's module.

The port's own copy of those op names (aliases included), so that the
registry can tell an op still to come from a name nobody registers. Each
family waits for ``ROADMAP.md`` queue 1 item 9, except ``list_ops``,
which only the TF importer (item 11) uses. The ``_bp`` ops derived from a
pending forward are pending with it (``autobp.py``).
"""
from __future__ import annotations

PENDING = {
    "bitwise_ops": (
        "bits_hamming_distance", "bitwise_and", "bitwise_or", "bitwise_xor",
        "cyclic_rshift_bits", "cyclic_shift_bits", "rshift_bits",
        "shift_bits", "toggle_bits"),
    "compression": (
        "decode_bitmap", "decode_threshold", "encode_bitmap",
        "encode_threshold"),
    # the decompositions; the "blas" half (matmul, batched_gemm,
    # tensormmul, einsum) is ported in linalg_ops.py
    "linalg_ops": (
        "cholesky", "cross_batched", "eig", "knn_mindistance",
        "log_matrix_determinant", "logdet", "lstsq", "lu",
        "matrix_determinant", "matrix_inverse", "qr", "self_adjoint_eig",
        "solve", "solve_ls", "sqrtm", "svd", "triangular_solve"),
    "list_ops": (
        "clone_list", "create_list", "delete_list", "gather_list",
        "pick_list", "read_list", "scatter_list", "size_list", "split_list",
        "stack_list", "unstack_list", "write_list"),
    "parity_extra": (
        "Assert", "barnes_edge_forces", "barnes_gains", "barnes_symmetrized",
        "broadcastgradientargs", "cell_contains", "compare_and_bitpack",
        "confusion_matrix", "conv2d_input_bp", "create_view", "ctc_beam",
        "deconv2d_tf", "fake_quant_with_min_max_vars",
        "fake_quant_with_min_max_vars_per_channel", "min_max_datatype",
        "norm", "print_variable"),
    "segment_ops": (
        "segment_max", "segment_mean", "segment_min", "segment_prod",
        "segment_sum", "unsorted_segment_max", "unsorted_segment_mean",
        "unsorted_segment_min", "unsorted_segment_prod",
        "unsorted_segment_sqrt_n", "unsorted_segment_sum"),
    "string_ops": (
        "compat_sparse_to_dense", "compat_string_split", "hashcode",
        "split_string"),
    # descriptors.py registers no op of its own (op-descriptor metadata)
    "descriptors": (),
}

#: the ROADMAP.md queue 1 item each family waits for (9 unless listed)
_ITEMS = {"list_ops": 11}


def pending_item(family: str) -> int:
    return _ITEMS.get(family, 9)


def register_pending(registry):
    for family, names in PENDING.items():
        for name in names:
            registry.add_pending(name, family)
