"""VALOR serving, training (from disk, through ``cli/train.py``) and retrieval
evaluation on PyTorch and CUDA (Hopper).

The PyTorch counterpart of ``valor_tpu``: same module layout and names,
PyTorch idiom inside.  It imports neither JAX nor ``valor_tpu``; the JAX
package is the reference its tests hold it to.  Every LayerNorm runs the
hand-written CUDA kernels in ``csrc/layernorm.cu`` on a CUDA tensor, forward
and backward.
"""
