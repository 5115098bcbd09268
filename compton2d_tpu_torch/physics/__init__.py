"""Physics: electron distributions, cross sections, emissivities."""
