with eu as (
    select s_suppkey, s_acctbal, n_name
    from supplier
        join nation on s_nationkey = n_nationkey
        join region on n_regionkey = r_regionkey
    where r_name = 'EUROPE'
),
j as (
    select ps_partkey, ps_suppkey, ps_supplycost, p_mfgr, s_acctbal, n_name
    from partsupp
        join part on ps_partkey = p_partkey
        join eu on ps_suppkey = s_suppkey
    where p_size = 15 and p_type like '%BRASS'
),
mn as (
    select ps_partkey as mk, min(ps_supplycost) as min_cost
    from j
    group by ps_partkey
)
select s_acctbal, n_name, ps_suppkey, ps_partkey, p_mfgr
from j
    join mn on ps_partkey = mk
where ps_supplycost = min_cost
order by s_acctbal desc, n_name, ps_suppkey, ps_partkey
limit 100
