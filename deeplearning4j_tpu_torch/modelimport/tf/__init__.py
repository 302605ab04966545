from .importer import TFGraphImporter, import_tf_graph

__all__ = ["TFGraphImporter", "import_tf_graph"]
