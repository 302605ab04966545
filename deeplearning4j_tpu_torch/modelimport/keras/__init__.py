from .importer import (KerasModelImport, import_keras_model_and_weights,
                       import_keras_sequential_model_and_weights,
                       register_lambda)

__all__ = ["KerasModelImport", "import_keras_model_and_weights",
           "import_keras_sequential_model_and_weights", "register_lambda"]
