"""Hand-written Hopper kernels of the port, their wrappers and their plain
versions.

segment_spmm -- batched weighted neighbor scatter-add (CUDA C++, sm_90a),
                one launch per message-passing layer for a bucket batch;
                its backward's dh is the same kernel with src and dst swapped
sed_pool     -- fused Eq.-1 SED weighting + segment pooling, unaged and
                aged (CUDA C++, sm_90a), one launch per pooling
quant        -- pack and unpack of the compressed exchange wire format
                (bf16, int8 + per-row scale; nearest-even and stochastic
                rounding) (CUDA C++, sm_90a), one launch per exchanged
                buffer

ops.py holds the public wrappers and launch counts (counts.py the
thread-safe counter); ref.py the plain-torch versions; csrc/ the CUDA
sources; _build.py builds them with nvcc.
"""
