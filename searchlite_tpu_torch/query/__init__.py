"""Query execution: parsing, planning, filters, phrases, sort, aggs."""
