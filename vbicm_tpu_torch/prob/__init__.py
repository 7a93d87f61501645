from .datagen import (
    MeasurementDataset,
    cached_dataset,
    generate_data_fem,
    load_dataset,
    save_dataset,
    standardize,
)
from .randomfield import (
    KLExpansion,
    build_kl_expansion,
    element_centroids,
    field_from_theta,
    make_fh_fun_field,
    make_mean_field_preconditioner,
    make_mean_field_preconditioner_box3d,
    posterior_field_moments,
)

__all__ = ["MeasurementDataset", "cached_dataset", "generate_data_fem", "load_dataset", "save_dataset",
           "standardize", "KLExpansion", "build_kl_expansion", "element_centroids",
           "field_from_theta", "make_fh_fun_field", "make_mean_field_preconditioner",
           "make_mean_field_preconditioner_box3d", "posterior_field_moments"]
