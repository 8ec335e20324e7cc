"""DeepSpeed-TPU installation (reference setup.py, minus CUDA extensions —
the TPU compute path is JAX/XLA/Pallas; the native host pieces build as
ctypes shared libraries from csrc/ at install time, with an on-demand
rebuild fallback in the loader for source checkouts)."""

import os
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py

_HERE = os.path.dirname(os.path.abspath(__file__))


class BuildNativeThenPy(build_py):
    """Build csrc/ ctypes libraries before packaging (reference setup.py
    built its op extensions here; DS_BUILD_OPS=0 skips, like the
    reference's env toggles). Serialized through the same .buildlock the
    runtime loader uses, so a concurrent importer never dlopens a
    half-written .so."""

    def run(self):
        csrc = os.path.join(_HERE, "csrc")
        if os.environ.get("DS_BUILD_OPS", "1") != "0":
            if os.path.isdir(csrc):
                # best-effort, mirroring the runtime loader's graceful
                # numpy fallback: a non-POSIX or make-less environment
                # must still pip-install cleanly
                try:
                    lock = os.path.join(_HERE, "deepspeed_tpu", "ops",
                                        "adam",
                                        "libdstpu_adam.so.buildlock")
                    with open(lock, "w") as fh:
                        import fcntl
                        fcntl.flock(fh, fcntl.LOCK_EX)
                        subprocess.check_call(["make", "-C", csrc])
                except Exception as e:  # noqa: BLE001
                    print(f"deepspeed_tpu: native build skipped ({e!r}) "
                          "— the runtime loader falls back to the numpy "
                          "Adam path")
            else:
                print("deepspeed_tpu: csrc/ not present (sdist without "
                      "sources?) — skipping native build; the runtime "
                      "loader falls back to the numpy Adam path")
        super().run()


setup(
    cmdclass={"build_py": BuildNativeThenPy},
    name="deepspeed_tpu",
    version="0.1.0",
    description="TPU-native deep learning optimization library: ZeRO, "
                "pipeline/3D parallelism, fused Pallas kernels, sparse "
                "attention — DeepSpeed capabilities on JAX/XLA",
    packages=find_packages(include=["deepspeed_tpu", "deepspeed_tpu.*",
                                    "deepspeed_tpu_torch",
                                    "deepspeed_tpu_torch.*"]),
    package_data={"deepspeed_tpu.ops.adam": ["*.so"],
                  "deepspeed_tpu.ops.attention": ["block_table.json"],
                  # the port's CUDA sources, built with nvcc at first use
                  "deepspeed_tpu_torch": ["csrc/*.cu"]},
    scripts=["bin/dstpu", "bin/ds", "bin/dstpu_ssh"],
    python_requires=">=3.10",
    install_requires=["jax", "numpy"],
)
