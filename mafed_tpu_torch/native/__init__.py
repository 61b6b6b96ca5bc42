from mafed_tpu_torch.native.engine import NativeImageEngine, get_engine, native_available

__all__ = ["NativeImageEngine", "get_engine", "native_available"]
