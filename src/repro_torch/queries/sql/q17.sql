with ls as (
    select l_partkey, l_quantity, l_extendedprice
    from lineitem
    where l_partkey in (select p_partkey from part
                        where p_brand = 'Brand#23'
                          and p_container = 'MED BOX')
),
agg0 as (
    select l_partkey as pk, avg(l_quantity) as avg_qty
    from ls
    group by l_partkey
)
select sum(l_extendedprice) / 7.0 as avg_yearly
from ls
    join agg0 on l_partkey = pk
where l_quantity < 0.2 * avg_qty
