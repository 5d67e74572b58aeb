from .snp_etl import (  # noqa: F401
    dbsnp_to_hapmap,
    filter_hapmap_against_genome,
    vcf_to_hapmap,
)
