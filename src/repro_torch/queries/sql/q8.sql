with america as (
    select n_nationkey
    from nation
        join region on n_regionkey = r_regionkey
    where r_name = 'AMERICA'
)
select year(o_orderdate) as o_year,
       sum(case when s_nationkey = code('n_name', 'BRAZIL')
                then l_extendedprice * (1 - l_discount) else 0.0 end)
         / sum(l_extendedprice * (1 - l_discount)) as mkt_share
from lineitem
    join orders on l_orderkey = o_orderkey
    join supplier on l_suppkey = s_suppkey
where l_partkey in (select p_partkey from part
                    where p_type = 'ECONOMY ANODIZED STEEL')
  and o_custkey in (select c_custkey from customer
                    where c_nationkey in (select n_nationkey from america))
  and o_orderdate >= date '1995-01-01'
  and o_orderdate <= date '1996-12-31'
group by o_year
order by o_year
