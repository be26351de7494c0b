"""Post-processing and visualisation (the reference's postProcess* and
Plot3D).  matplotlib and plotly are imported inside the functions, so the
package imports without them."""

from percnn_tpu_torch.viz.plots import (comparison_panel, frame_series, ic_panel,
                                        isosurface_pair, measurement_panel, pareto_panel,
                                        save_isosurface_html)

__all__ = ["comparison_panel", "frame_series", "ic_panel", "isosurface_pair",
           "measurement_panel", "pareto_panel", "save_isosurface_html"]
