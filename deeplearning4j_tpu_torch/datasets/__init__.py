from .dataset import DataSet, MultiDataSet  # noqa: F401
from .iterators import (ArrayDataSetIterator, AsyncDataSetIterator,  # noqa: F401
                        DataSetIterator, ListDataSetIterator)
