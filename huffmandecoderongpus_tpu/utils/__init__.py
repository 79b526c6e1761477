"""Cross-cutting utilities: compile cache, debug dumps, logging.

Counterparts of the reference's auxiliary subsystems (SURVEY §5):
the OpenCL kernel-binary cache (openclapproach.c:26-225) becomes the XLA
persistent compilation cache; the DEBUG/FGPUDEBUG intermediate-buffer dumps
(fastgpu.cu:226-273, openclapproach.c:431-606) become the env-gated
:mod:`debug` helpers.
"""

from huffmandecoderongpus_tpu.utils.compile_cache import enable_compile_cache  # noqa: F401
from huffmandecoderongpus_tpu.utils.debug import debug_enabled, dump  # noqa: F401
