from cova_tpu.query.metrics import (  # noqa: F401
    arange_ts,
    Boxes,
    calculate_query,
    exclude_regions,
    load_boxes_csv,
    load_cova,
    local_region,
    parse_query,
    QueryResult,
)
