"""The graph IR's op registry in the PyTorch port
(``deeplearning4j_torch.autodiff.ops``) against the JAX package's: the
same names (the importer's extra ops included), and every op's outputs
(f32, 1e-5) and gradients on the same seeded numpy inputs — device
values as jax arrays / CPU tensors, host operands (shapes, axes,
paddings) as numpy on both sides; then the frozen TensorFlow graphs of
``tests/test_op_parity.py`` imported by both packages, each run against
TensorFlow's own output."""
import dataclasses

import numpy as np
import pytest
import torch

from deeplearning4j_torch.autodiff import ops as P
from deeplearning4j_torch.autodiff import tf_import as PT

jax = pytest.importorskip("jax")
jnp = jax.numpy
from deeplearning4j_tpu.autodiff import ops as R  # noqa: E402
from deeplearning4j_tpu.autodiff import tf_import as RT  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@dataclasses.dataclass
class S:
    """A host operand: numpy on both sides (constant-folded)."""
    v: object


_r = np.random.default_rng(0)


def f32(*shape, scale=1.0):
    return (_r.normal(size=shape) * scale).astype(np.float32)


def pos(*shape):
    return (np.abs(_r.normal(size=shape)) + 0.1).astype(np.float32)


A, B, POS = f32(3, 4), f32(3, 4), pos(3, 4)
M45, T234, B4 = f32(4, 5), f32(2, 3, 4), f32(4)
BOOL = A > 0
BOOL2 = B > 0
_spd = f32(4, 4)
SPD = (_spd @ _spd.T + 4.0 * np.eye(4, dtype=np.float32))
IMG = f32(2, 6, 6, 3)
NCHW = f32(2, 3, 6, 6)
QKV = [f32(2, 2, 8, 4) for _ in range(3)]
I32 = lambda *v: np.asarray(v, np.int32)  # noqa: E731

# (id, op, args, attrs, differentiable)
CASES = [
    ("add", "add", (A, B), {}, True),
    ("sub", "sub", (A, B), {}, True),
    ("mul", "mul", (A, B), {}, True),
    ("div", "div", (A, POS), {}, True),
    ("floordiv", "floordiv", (3 * A, POS), {}, False),
    ("mod", "mod", (3 * A, POS), {}, False),
    ("pow", "pow", (POS, A), {}, True),
    ("maximum", "maximum", (A, B), {}, True),
    ("minimum", "minimum", (A, B), {}, True),
    ("squared_difference", "squared_difference", (A, B), {}, True),
    ("add_host", "add", (S(A), S(B)), {}, False),
    ("equal", "equal", (np.round(A), np.round(B)), {}, False),
    ("not_equal", "not_equal", (np.round(A), np.round(B)), {}, False),
    ("greater", "greater", (A, B), {}, False),
    ("less", "less", (A, B), {}, False),
    ("greater_equal", "greater_equal", (A, B), {}, False),
    ("less_equal", "less_equal", (A, B), {}, False),
    ("logical_and", "logical_and", (BOOL, BOOL2), {}, False),
    ("logical_or", "logical_or", (BOOL, BOOL2), {}, False),
    ("neg", "neg", (A,), {}, True),
    ("abs", "abs", (A,), {}, True),
    ("sign", "sign", (A,), {}, False),
    ("exp", "exp", (A,), {}, True),
    ("log", "log", (POS,), {}, True),
    ("log1p", "log1p", (POS,), {}, True),
    ("sqrt", "sqrt", (POS,), {}, True),
    ("rsqrt", "rsqrt", (POS,), {}, True),
    ("square", "square", (A,), {}, True),
    ("reciprocal", "reciprocal", (POS,), {}, True),
    ("floor", "floor", (3 * A,), {}, False),
    ("ceil", "ceil", (3 * A,), {}, False),
    ("round", "round", (3 * A,), {}, False),
    ("sin", "sin", (A,), {}, True),
    ("cos", "cos", (A,), {}, True),
    ("tan", "tan", (A,), {}, True),
    ("tanh", "tanh", (A,), {}, True),
    ("sigmoid", "sigmoid", (A,), {}, True),
    ("erf", "erf", (A,), {}, True),
    ("relu", "relu", (A,), {}, True),
    ("relu6", "relu6", (5 * A,), {}, True),
    ("elu", "elu", (A,), {}, True),
    ("selu", "selu", (A,), {}, True),
    ("softplus", "softplus", (A,), {}, True),
    ("softsign", "softsign", (A,), {}, True),
    ("logical_not", "logical_not", (BOOL,), {}, False),
    ("isnan", "isnan", (np.where(BOOL, A, np.nan).astype(np.float32),),
     {}, False),
    ("isinf", "isinf", (np.where(BOOL, A, np.inf).astype(np.float32),),
     {}, False),
    ("identity", "identity", (A,), {}, True),
    ("stop_gradient", "stop_gradient", (A,), {}, True),
    ("erfc", "erfc", (A,), {}, True),
    ("leaky_relu", "leaky_relu", (A,), {"alpha": 0.3}, True),
    ("gelu_tanh", "gelu", (A,), {}, True),
    ("gelu_exact", "gelu", (A,), {"approximate": False}, True),
    ("clip_by_value", "clip_by_value",
     (A, S(np.float32(-0.5)), S(np.float32(0.5))), {}, True),
    ("cast_int", "cast", (3 * A,), {"dtype": "int32"}, False),
    ("cast_host", "cast", (S(3 * A),), {"dtype": "int32"}, False),
    ("matmul", "matmul", (A, M45), {}, True),
    ("matmul_tb", "matmul", (A, B), {"transpose_b": True}, True),
    ("matmul_ta", "matmul", (A, B), {"transpose_a": True}, True),
    ("matmul_batched", "matmul", (T234, f32(2, 4, 3)), {}, True),
    ("matmul_expect_k_inner", "matmul", (T234, M45), {"expect_k": 4}, True),
    ("matmul_expect_k_flatten", "matmul", (f32(2, 3, 4), f32(12, 5)),
     {"expect_k": 12}, True),
    ("tensordot", "tensordot", (A, M45), {"axes": 1}, True),
    ("bias_add", "bias_add", (A, B4), {}, True),
    ("reduce_sum", "reduce_sum", (A, S(1)), {}, True),
    ("reduce_sum_all", "reduce_sum", (T234,), {}, True),
    ("reduce_sum_int", "reduce_sum", (np.round(3 * A).astype(np.int32),
                                      S(0)), {}, False),
    ("reduce_mean_keep", "reduce_mean", (T234, S(-1)),
     {"keep_dims": True}, True),
    ("reduce_mean_axes", "reduce_mean", (T234, S([0, 2])), {}, True),
    ("reduce_max", "reduce_max", (A, S(0)), {}, True),
    ("reduce_min", "reduce_min", (A, S(1)), {"keep_dims": True}, True),
    ("reduce_prod", "reduce_prod", (POS, S([0, 1])), {}, True),
    ("reduce_any", "reduce_any", (BOOL, S(1)), {}, False),
    ("reduce_all", "reduce_all", (BOOL, S(0)), {}, False),
    ("reduce_host", "reduce_sum", (S(A), S(1)), {}, False),
    ("argmax", "argmax", (A,), {"axis": 1}, False),
    ("argmin", "argmin", (A,), {"axis": 0}, False),
    ("cumsum", "cumsum", (A,), {"axis": 1}, True),
    ("cumsum_exclusive_reverse", "cumsum", (A,),
     {"axis": 0, "exclusive": True, "reverse": True}, True),
    ("cumsum_exclusive", "cumsum", (A,), {"axis": 1, "exclusive": True},
     True),
    ("cumprod", "cumprod", (POS,), {"axis": 1}, True),
    ("cumprod_exclusive_reverse", "cumprod", (POS,),
     {"axis": 1, "exclusive": True, "reverse": True}, True),
    ("shape", "shape", (T234,), {}, False),
    ("size", "size", (T234,), {}, False),
    ("rank", "rank", (T234,), {}, False),
    ("reshape", "reshape", (T234, S([4, -1])), {}, True),
    ("reshape_host", "reshape", (S(T234), S([4, -1])), {}, False),
    ("transpose", "transpose", (T234, S([1, 0, 2])), {}, True),
    ("transpose_reverse", "transpose", (T234,), {}, True),
    ("expand_dims", "expand_dims", (A, S(1)), {}, True),
    ("expand_dims_last", "expand_dims", (A,), {"axis": -1}, True),
    ("squeeze", "squeeze", (f32(2, 1, 3, 1),), {"axis": [1]}, True),
    ("squeeze_all", "squeeze", (f32(2, 1, 3, 1),), {}, True),
    ("concat", "concat", (A, B), {"axis": 1}, True),
    ("concat_host", "concat", (S(I32(1, 2)), S(I32(3))), {"axis": 0},
     False),
    ("pack", "pack", (A, B), {"axis": 1}, True),
    ("unstack", "unstack", (T234,), {"axis": 1, "num": 3}, True),
    ("split", "split", (A,), {"num_split": 2, "axis": 1}, True),
    ("split_sizes", "split", (A,), {"num_split": [1, 3], "axis": -1}, True),
    ("tile", "tile", (A, S([2, 1])), {}, True),
    ("slice", "slice", (A, S([1, 0]), S([2, -1])), {}, True),
    ("strided_slice", "strided_slice", (A, S([1, 0]), S([3, 3]),
                                        S([1, 2])), {}, True),
    ("strided_slice_masks", "strided_slice",
     (T234, S([0, 1, 0]), S([0, 2, 3]), S([1, 1, 1])),
     {"begin_mask": 1, "end_mask": 1, "shrink_axis_mask": 2}, True),
    ("strided_slice_new_axis_ellipsis", "strided_slice",
     (T234, S([0, 0, 1]), S([0, 0, 3]), S([1, 1, 1])),
     {"new_axis_mask": 1, "ellipsis_mask": 2}, True),
    ("strided_slice_reverse", "strided_slice",
     (A, S([0, 3]), S([0, 0]), S([1, -2])),
     {"begin_mask": 1, "end_mask": 1}, True),
    ("strided_slice_host", "strided_slice",
     (S(np.asarray([2, 16, 64], np.int64)), S([1]), S([2]), S([1])),
     {"shrink_axis_mask": 1}, False),
    ("gather", "gather", (A, S(I32(2, 0))), {"axis": 0}, True),
    ("gather_axis1", "gather", (A, S(I32(3, 1, 3))), {"axis": 1}, True),
    ("gather_device_ids", "gather", (f32(10, 4), I32([1, 9, -1], [0, 0, 3])),
     {}, True),
    ("gather_batch_dims", "gather", (T234, I32([2, 0], [1, 1])),
     {"axis": 1, "batch_dims": 1}, True),
    ("gather_host", "gather", (S(I32(5, 6, 7)), S(I32(2, 0))), {}, False),
    ("gather_nd", "gather_nd", (A, I32([0, 1], [2, 3])), {}, True),
    ("scatter_nd", "scatter_nd", (I32([0], [2], [0]), f32(3, 4), S([3, 4])),
     {}, True),
    ("one_hot", "one_hot", (I32(0, 2, 1, -1),), {"depth": 4}, False),
    ("one_hot_axis0", "one_hot", (I32(0, 2, 1),),
     {"depth": 3, "on_value": 2.0, "off_value": -1.0, "axis": 0}, False),
    ("fill_host", "fill", (S([2, 3]), S(1.5)), {}, False),
    ("fill", "fill", (S([2, 3]), np.float32(1.5)), {}, False),
    ("zeros_like", "zeros_like", (A,), {}, False),
    ("ones_like", "ones_like", (A,), {}, False),
    ("range", "range", (S(0), S(9), S(2)), {}, False),
    ("pad", "pad", (A, S([[1, 0], [0, 2]])), {"constant_value": 0.5},
     True),
    ("broadcast_to", "broadcast_to", (B4, S([3, 4])), {}, True),
    ("where", "where", (BOOL, A, B), {}, True),
    ("select", "select", (BOOL, A, B), {}, True),
    ("softmax", "softmax", (A,), {}, True),
    ("softmax_axis0", "softmax", (A,), {"axis": 0}, True),
    ("log_softmax", "log_softmax", (A,), {}, True),
    ("softmax_cross_entropy_with_logits",
     "softmax_cross_entropy_with_logits",
     (np.full((3, 4), 0.25, np.float32), A), {}, True),
    ("sparse_softmax_cross_entropy_with_logits",
     "sparse_softmax_cross_entropy_with_logits", (I32(0, 2, 1), A), {},
     True),
    ("sigmoid_cross_entropy_with_logits",
     "sigmoid_cross_entropy_with_logits",
     ((B > 0).astype(np.float32), A), {}, True),
    ("layer_norm", "layer_norm", (T234, f32(4), f32(4)), {"eps": 1e-5},
     True),
    ("dropout", "dropout", (A,), {"rate": 0.1}, True),
    ("l2_normalize", "l2_normalize", (A,), {}, True),
    ("embedding_lookup", "embedding_lookup", (f32(10, 4), I32([1, 9], [0, 3])),
     {}, True),
    ("conv2d_same", "conv2d", (IMG, f32(3, 3, 3, 5)), {}, True),
    ("conv2d_stride2_same", "conv2d", (f32(2, 7, 7, 3), f32(3, 3, 3, 5)),
     {"strides": (2, 2)}, True),
    ("conv2d_valid_dilated", "conv2d", (IMG, f32(2, 2, 3, 5)),
     {"padding": "VALID", "dilations": (2, 2)}, True),
    ("conv2d_explicit", "conv2d", (IMG, f32(3, 3, 3, 2)),
     {"padding": [(1, 0), (0, 2)]}, True),
    ("max_pool", "max_pool", (IMG,), {}, True),
    ("max_pool_same", "max_pool", (f32(2, 5, 5, 3),),
     {"ksize": (3, 3), "strides": (2, 2), "padding": "SAME"}, True),
    ("avg_pool", "avg_pool", (IMG,), {}, True),
    ("avg_pool_same", "avg_pool", (f32(2, 5, 5, 3),),
     {"ksize": (3, 3), "strides": (2, 2), "padding": "SAME"}, True),
    ("fused_attention", "fused_attention", tuple(QKV), {"scale": 0.5},
     True),
    ("fused_attention_bias", "fused_attention",
     tuple(QKV) + (np.where(f32(2, 1, 1, 8) > 0.5, -1e9, 0.0)
                   .astype(np.float32),), {"scale": 0.5}, True),
    ("fused_attention_causal", "fused_attention", tuple(QKV),
     {"causal": True}, True),
    ("fused_attention_3d", "fused_attention",
     tuple(x[:, 0] for x in QKV), {"scale": 0.3}, True),
    ("fused_attention_qk_bias", "fused_attention",
     tuple(QKV) + (np.triu(np.full((8, 8), -1e9, np.float32), k=1),),
     {"bias_layout": "qk", "scale": 0.5}, True),
    ("asin", "asin", (np.clip(A, -0.9, 0.9),), {}, True),
    ("acos", "acos", (np.clip(A, -0.9, 0.9),), {}, True),
    ("atan", "atan", (A,), {}, True),
    ("sinh", "sinh", (A,), {}, True),
    ("cosh", "cosh", (A,), {}, True),
    ("asinh", "asinh", (A,), {}, True),
    ("acosh", "acosh", (POS + 1.0,), {}, True),
    ("atanh", "atanh", (np.clip(A, -0.9, 0.9),), {}, True),
    ("expm1", "expm1", (A,), {}, True),
    ("rint", "rint", (3.3 * A,), {}, False),
    ("isfinite", "isfinite", (np.where(BOOL, A, np.inf).astype(np.float32),),
     {}, False),
    ("lgamma", "lgamma", (POS,), {}, True),
    ("digamma", "digamma", (POS,), {}, True),
    ("atan2", "atan2", (A, B), {}, True),
    ("xlogy", "xlogy", (np.where(BOOL, np.abs(A), 0).astype(np.float32),
                        POS), {}, True),
    ("xdivy", "xdivy", (np.where(BOOL, A, 0).astype(np.float32), POS), {},
     True),
    ("logical_xor", "logical_xor", (BOOL, BOOL2), {}, False),
    ("l2_loss", "l2_loss", (A,), {}, True),
    ("add_n", "add_n", (A, B, A), {}, True),
    ("reverse", "reverse", (A, S([1])), {}, True),
    ("roll", "roll", (A, S([1, -2]), S([0, 1])), {}, True),
    ("top_k", "top_k", (A,), {"k": 2}, True),
    ("invert_permutation", "invert_permutation", (I32(2, 0, 3, 1),), {},
     False),
    ("matrix_band_part", "matrix_band_part", (f32(4, 4), S(1), S(1)), {},
     True),
    ("matrix_band_part_lower", "matrix_band_part", (f32(2, 4, 4), S(-1),
                                                    S(0)), {}, True),
    ("mirror_pad_reflect", "mirror_pad", (A, S([[1, 1], [2, 0]])),
     {"mode": "REFLECT"}, True),
    ("mirror_pad_symmetric", "mirror_pad", (A, S([[1, 1], [0, 2]])),
     {"mode": "SYMMETRIC"}, True),
    ("tensor_scatter_update", "tensor_scatter_update",
     (A, I32([0], [2]), f32(2, 4)), {}, True),
    ("tensor_scatter_add", "tensor_scatter_add",
     (A, I32([1], [1]), f32(2, 4)), {}, True),
    ("depth_to_space", "depth_to_space", (f32(1, 2, 3, 8),), {}, True),
    ("space_to_depth", "space_to_depth", (f32(1, 4, 6, 2),), {}, True),
    ("space_to_batch_nd", "space_to_batch_nd",
     (f32(1, 4, 3, 3), S([2, 2]), S([[0, 0], [1, 0]])), {}, True),
    ("batch_to_space_nd", "batch_to_space_nd",
     (f32(4, 2, 2, 3), S([2, 2]), S([[0, 1], [1, 0]])), {}, True),
    ("resize_bilinear_up", "resize_bilinear", (f32(1, 3, 4, 2), S([6, 8])),
     {}, True),
    ("resize_bilinear_down", "resize_bilinear", (f32(1, 6, 8, 2),
                                                 S([3, 5])), {}, True),
    ("resize_bilinear_legacy", "resize_bilinear",
     (f32(1, 3, 4, 2), S([6, 7])), {"half_pixel_centers": False}, True),
    ("resize_nearest_up", "resize_nearest", (f32(1, 3, 4, 2), S([6, 8])),
     {}, True),
    ("resize_nearest_down", "resize_nearest", (f32(1, 6, 8, 2), S([4, 3])),
     {}, True),
    ("resize_nearest_legacy", "resize_nearest",
     (f32(1, 3, 4, 2), S([6, 7])), {"half_pixel_centers": False}, True),
    ("unsorted_segment_sum", "unsorted_segment_sum",
     (A, I32(1, 0, 1), S(2)), {}, True),
    ("unsorted_segment_mean", "unsorted_segment_mean",
     (T234, I32(1, 0), S(3)), {}, True),
    ("unsorted_segment_max", "unsorted_segment_max",
     (A, I32(0, 0, 2), S(3)), {}, True),
    ("conv2d_transpose_odd", "conv2d_transpose",
     (f32(2, 3, 3, 5), f32(3, 3, 3, 5)),
     {"strides": (2, 2), "output_shape": [2, 5, 5, 3]}, True),
    ("conv2d_transpose_valid", "conv2d_transpose",
     (f32(2, 4, 4, 5), f32(3, 3, 3, 5)),
     {"strides": (2, 2), "padding": "VALID", "output_shape": [2, 9, 9, 3]},
     True),
    ("conv2d_transpose_noshape_same", "conv2d_transpose",
     (f32(2, 4, 4, 5), f32(3, 3, 3, 5)), {"strides": (2, 2)}, True),
    ("conv2d_transpose_noshape_valid", "conv2d_transpose",
     (f32(2, 4, 4, 5), f32(3, 3, 3, 5)),
     {"strides": (2, 2), "padding": "VALID"}, True),
    ("depthwise_conv2d", "depthwise_conv2d", (IMG, f32(3, 3, 3, 2)), {},
     True),
    ("conv3d", "conv3d", (f32(1, 4, 4, 4, 2), f32(2, 2, 2, 2, 3)), {},
     True),
    ("max_pool3d", "max_pool3d", (f32(1, 4, 4, 4, 2),), {}, True),
    ("avg_pool3d", "avg_pool3d", (f32(1, 4, 4, 4, 2),), {}, True),
    ("lrn", "lrn", (f32(1, 3, 3, 8),),
     {"depth_radius": 2, "bias": 1.0, "alpha": 0.5, "beta": 0.6}, True),
    ("softmax_cross_entropy_with_logits_v2",
     "softmax_cross_entropy_with_logits_v2",
     (A, np.full((3, 4), 0.25, np.float32)), {}, True),
    ("sparse_softmax_cross_entropy_with_logits_v2",
     "sparse_softmax_cross_entropy_with_logits_v2", (A, I32(0, 2, 1)), {},
     True),
    ("matrix_inverse", "matrix_inverse", (SPD,), {}, True),
    ("matrix_inverse_adjoint", "matrix_inverse", (SPD + f32(4, 4),),
     {"adjoint": True}, True),
    ("cholesky", "cholesky", (SPD,), {}, True),
    ("matrix_determinant", "matrix_determinant", (SPD,), {}, True),
    ("matrix_triangular_solve", "matrix_triangular_solve",
     (np.tril(SPD), f32(4, 2)), {}, True),
    ("matrix_triangular_solve_upper_adjoint", "matrix_triangular_solve",
     (np.triu(SPD), f32(4, 2)), {"lower": False, "adjoint": True}, True),
    ("matrix_diag", "matrix_diag", (f32(2, 3),), {}, True),
    ("matrix_diag_part", "matrix_diag_part", (f32(2, 3, 3),), {}, True),
    ("matrix_set_diag", "matrix_set_diag", (f32(3, 3), f32(3)), {}, True),
    ("reshape_with_zero", "reshape_with_zero", (T234,),
     {"shape": [0, -1]}, True),
    ("flatten_onnx", "flatten_onnx", (f32(2, 3, 4, 5),), {"axis": 2}, True),
    ("unsqueeze_onnx", "unsqueeze_onnx", (A,), {"axis": [-1, -3]}, True),
    ("unsqueeze_onnx_host", "unsqueeze_onnx", (S(I32(4, 5)),),
     {"axis": [0]}, False),
    ("softmax_onnx_pre13", "softmax_onnx_pre13", (T234,), {"axis": 1},
     True),
    ("clip_scalar", "clip_scalar", (A,), {"lo": -0.3, "hi": 0.4}, True),
    ("onnx_conv", "onnx_conv", (NCHW, f32(4, 3, 3, 3), f32(4)),
     {"pads": [1, 1, 1, 1]}, True),
    ("onnx_conv_same_lower_group", "onnx_conv", (NCHW, f32(6, 1, 3, 3)),
     {"strides": (2, 2), "auto_pad": "SAME_LOWER", "group": 3}, True),
    ("onnx_conv_dilated", "onnx_conv", (NCHW, f32(2, 3, 2, 2)),
     {"dilations": (2, 2), "auto_pad": "SAME_UPPER"}, True),
    ("onnx_max_pool", "onnx_max_pool", (NCHW,),
     {"kernel_shape": (3, 3), "strides": (2, 2), "pads": [1, 1, 1, 1]},
     True),
    ("onnx_avg_pool", "onnx_avg_pool", (NCHW,),
     {"kernel_shape": (3, 3), "strides": (2, 2), "pads": [1, 1, 0, 0]},
     True),
    ("onnx_avg_pool_include_pad", "onnx_avg_pool", (NCHW,),
     {"kernel_shape": (3, 3), "strides": (1, 1), "pads": [1, 1, 1, 1],
      "count_include_pad": 1}, True),
    ("onnx_global_avg_pool", "onnx_global_avg_pool", (NCHW,), {}, True),
    ("onnx_batch_norm", "onnx_batch_norm",
     (NCHW, f32(3), f32(3), f32(3), pos(3)), {}, True),
    ("onnx_layer_norm", "onnx_layer_norm", (T234, f32(4), f32(4)), {}, True),
    ("onnx_layer_norm_axis1", "onnx_layer_norm", (T234, f32(3, 4)),
     {"axis": 1}, True),
    ("onnx_pad_constant", "onnx_pad", (A,),
     {"pads": [1, 0, 0, 2], "value": 0.5}, True),
    ("onnx_pad_reflect", "onnx_pad", (A,),
     {"pads": [1, 2, 1, 1], "mode": "reflect"}, True),
    ("onnx_pad_edge", "onnx_pad", (A,), {"pads": [1, 0, 2, 3],
                                          "mode": "edge"}, True),
    ("onnx_slice", "onnx_slice", (T234,),
     {"starts": [1, -1], "ends": [3, -5], "axes": [1, 2],
      "steps": [1, -2]}, True),
    ("lstm_block_cell", "lstm_block_cell",
     (f32(2, 3), f32(2, 4), f32(2, 4), f32(7, 16, scale=0.5), f32(4),
      f32(4), f32(4), f32(16)), {"use_peephole": True}, True),
    ("block_lstm", "block_lstm",
     (S(np.int64(2)), f32(3, 2, 3), f32(2, 4), f32(2, 4),
      f32(7, 16, scale=0.5), f32(4), f32(4), f32(4), f32(16)),
     {"gate_order": "ifco", "cell_clip": 0.0}, True),
    ("gru_block_cell", "gru_block_cell",
     (f32(2, 3), f32(2, 4), f32(7, 8, scale=0.5), f32(7, 4, scale=0.5),
      f32(8), f32(4)), {}, True),
    ("onnx_lstm", "onnx_lstm",
     (f32(4, 2, 3), f32(1, 16, 3, scale=0.5), f32(1, 16, 4, scale=0.5),
      f32(1, 32)), {"present": (0, 1, 2, 3), "hidden_size": 4}, True),
    ("onnx_lstm_bidirectional", "onnx_lstm",
     (f32(4, 2, 3), f32(2, 16, 3, scale=0.5), f32(2, 16, 4, scale=0.5),
      f32(2, 2, 4), f32(2, 2, 4)),
     {"present": (0, 1, 2, 5, 6), "direction": "bidirectional"}, True),
    ("onnx_gru", "onnx_gru",
     (f32(4, 2, 3), f32(1, 12, 3, scale=0.5), f32(1, 12, 4, scale=0.5),
      f32(1, 24)), {"present": (0, 1, 2, 3)}, True),
    ("onnx_gru_lbr_reverse", "onnx_gru",
     (f32(4, 2, 3), f32(1, 12, 3, scale=0.5), f32(1, 12, 4, scale=0.5),
      f32(1, 24), f32(1, 2, 4)),
     {"present": (0, 1, 2, 3, 5), "linear_before_reset": 1,
      "direction": "reverse"}, True),
    ("broadcast_to_dynamic", "broadcast_to_dynamic",
     (f32(3, 1), S(np.asarray([2, 1, 4], np.int64))), {}, True),
    ("reshape_dynamic", "reshape_dynamic",
     (T234, S(np.asarray([0, -1], np.int64))), {}, True),
    ("einsum", "einsum", (A, M45), {"equation": "ij,jk->ik"}, True),
    ("fused_batch_norm", "fused_batch_norm",
     (f32(2, 3, 3, 4), f32(4), f32(4), f32(4), pos(4)), {"eps": 1e-3},
     True),
]
# executed by SameDiff itself (tests/test_torch_control_flow.py)
NOT_IN_TABLE = {"while_loop", "cond"}


def test_registry_names_equal_the_reference():
    assert set(P.OP_REGISTRY) == set(R.OP_REGISTRY)
    assert "einsum" in P.OP_REGISTRY and "fused_batch_norm" in P.OP_REGISTRY
    for name, op in R.OP_REGISTRY.items():
        assert P.OP_REGISTRY[name].n_out == op.n_out, name


def test_every_op_has_a_case():
    covered = {c[1] for c in CASES} | NOT_IN_TABLE
    assert covered == set(R.OP_REGISTRY), \
        sorted(set(R.OP_REGISTRY) ^ covered)


def _is_float_operand(a):
    return isinstance(a, np.ndarray) and a.dtype.kind == "f"


def _ref(op, args, attrs, floats=None):
    vals = [a.v if isinstance(a, S) else jnp.asarray(a) for a in args]
    if floats is not None:
        for i, v in floats.items():
            vals[i] = v
    return R.OP_REGISTRY[op].fn(*vals, **attrs)


def _port(op, args, attrs, floats=None):
    vals = [a.v if isinstance(a, S) else torch.as_tensor(a) for a in args]
    if floats is not None:
        for i, v in floats.items():
            vals[i] = v
    with P.device_scope("cpu"):
        return P.OP_REGISTRY[op].fn(*vals, **attrs)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _outs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def _ref_run(op, args, attrs, idx, cts):
    """The reference's outputs and, with ``cts``, the gradients of
    sum_j <out_j, ct_j> wrt the operands ``idx`` — one jitted program
    (eager JAX compiles every primitive on its own, far slower)."""
    def outs(*xs):
        return _outs(_ref(op, args, attrs, dict(zip(idx, xs))))

    xs = [jnp.asarray(args[i]) for i in idx]
    if cts is None:
        return jax.jit(outs)(*xs), None

    def loss(*xs):
        out = outs(*xs)
        return sum(jnp.sum(out[j] * ct) for j, ct in cts.items()), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(xs))), has_aux=True))(*xs)
    return out, grads


@pytest.mark.parametrize("cid,op,args,attrs,diff", CASES,
                         ids=[c[0] for c in CASES])
def test_op_matches_reference(cid, op, args, attrs, diff):
    host = all(isinstance(a, S) for a in args)
    got = _outs(_port(op, args, attrs))
    # gradients: d/d(float operands) of sum_j <out_j, ct_j>
    idx = [i for i, a in enumerate(args) if _is_float_operand(a)]
    cts = {j: np.random.default_rng(7 + j).normal(size=tuple(g.shape))
           .astype(np.float32) for j, g in enumerate(got)
           if _np(g).dtype.kind == "f"} if diff else None
    want, want_g = ((_outs(_ref(op, args, attrs)), None) if host
                    else _ref_run(op, args, attrs, idx, cts))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        gn, wn = _np(g), np.asarray(w)
        assert gn.shape == wn.shape, (gn.shape, wn.shape)
        assert gn.dtype.kind == wn.dtype.kind, (gn.dtype, wn.dtype)
        if wn.dtype.kind == "f":
            assert gn.dtype.itemsize == wn.dtype.itemsize, (gn.dtype,
                                                            wn.dtype)
        np.testing.assert_allclose(gn, wn, rtol=TOL, atol=TOL)
    if host:        # folded on the host in both packages
        assert all(P.is_static_value(g) for g in got)
    if not diff:
        return
    leaves = [torch.tensor(args[i], requires_grad=True) for i in idx]
    out = _outs(_port(op, args, attrs, dict(zip(idx, leaves))))
    loss = sum(torch.sum(out[j] * torch.as_tensor(ct))
               for j, ct in cts.items())
    got_g = (torch.autograd.grad(loss, leaves, allow_unused=True)
             if loss.requires_grad else [None] * len(leaves))
    for i, g, w in zip(idx, got_g, want_g):
        g = np.zeros(np.shape(w), np.float32) if g is None else g.numpy()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4,
                                   err_msg=f"grad of operand {i}")


# ---------------------------------------------------------------------------
# TensorFlow op parity: the reference's frozen single-op graphs, imported
# by both packages
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tf_cases():
    pytest.importorskip("tensorflow")
    import importlib
    mod = importlib.import_module("test_op_parity")
    out = []
    for name, fn, inputs in mod.CASES:
        specs = [mod.tf.TensorSpec(x.shape, mod.tf.as_dtype(x.dtype))
                 for x in inputs]
        gd, _ = mod._freeze(fn, specs)
        ref = fn(*[mod.tf.constant(x) for x in inputs]).numpy()
        out.append((name, gd, inputs, ref))
    return out


def _first(outs):
    return outs.get("Identity", next(iter(outs.values())))


def test_tf_single_op_graphs_match_tensorflow_in_both(tf_cases):
    assert len(tf_cases) > 100
    bad = []
    for name, gd, inputs, ref in tf_cases:
        feeds = {f"a{i}": x for i, x in enumerate(inputs)}
        psd = PT.import_graph_def(gd, trainable_consts=False, device="cpu")
        rsd = RT.import_graph_def(gd, trainable_consts=False)
        got = _np(_first(psd.output(feeds)))
        want = np.asarray(_first(rsd.output(feeds)))
        for label, x in (("port", got), ("reference", want)):
            if x.shape != ref.shape or not np.allclose(
                    x, np.asarray(ref), atol=1e-5, rtol=1e-5):
                bad.append((name, label))
        if not np.allclose(got, want, atol=1e-5, rtol=1e-5):
            bad.append((name, "port vs reference"))
    assert not bad, bad
