"""Road networks as flat arrays: procedural towns, OSM import, routing,
queries (port of ``cilrs_tpu/maps``)."""
