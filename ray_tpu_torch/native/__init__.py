"""Native C++ components of the port (built with ``g++`` at first use into
``ray_tpu_torch/_build/native/``; the counterpart of ``ray_tpu/native/``).

- plasma: the host's shared-memory object arena (src/plasma.cc)
"""
