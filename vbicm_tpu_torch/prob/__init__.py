from .datagen import MeasurementDataset, generate_data_fem, standardize

__all__ = ["MeasurementDataset", "generate_data_fem", "standardize"]
