from .datagen import (
    MeasurementDataset,
    cached_dataset,
    generate_data_fem,
    load_dataset,
    save_dataset,
    standardize,
)

__all__ = ["MeasurementDataset", "cached_dataset", "generate_data_fem", "load_dataset", "save_dataset",
           "standardize"]
