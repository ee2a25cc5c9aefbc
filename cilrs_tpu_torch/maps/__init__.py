"""Road networks as flat arrays: procedural towns, routing, queries (port of
``cilrs_tpu/maps``). ``maps/osm.py`` (OSM import) is not ported yet."""
