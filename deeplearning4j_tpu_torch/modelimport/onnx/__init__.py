from .importer import OnnxImporter, import_onnx_model

__all__ = ["OnnxImporter", "import_onnx_model"]
