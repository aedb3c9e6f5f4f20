"""Hand-written Hopper kernels of the port and their plain versions.

K1 ``elastic_matmul`` and K2 ``flash_attention`` are CUDA C++ sources in
``csrc/``, built for ``sm_90a`` by ``build.py`` at first use and called
through ``ops.py``; ``ref.py`` holds the plain oracles.  Importing this
package builds nothing.
"""
